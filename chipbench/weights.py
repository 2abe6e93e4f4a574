"""The benchmark's weights: drawn on the device from ``--seed``.

One layout serves both sides.  Each leaf is named by its path in the
program's parameter tree (``layers.attn.wq``, stacked ``(L, ...)`` over
the layers, experts ``(L, E, ...)``), in the ``(in, out)`` matrix layout.
The program gets the leaves nested as its tree (:func:`as_tree`); the
reference reads the same names.  Each leaf has a generator of its own,
seeded from ``(seed, leaf)``, and is filled in place in a few large calls,
so any leaf can be drawn again alone, bit for bit, on the same device.

Scales: embedding rows N(0, 1); matrices N(0, 1/fan_in), fan_in their
input width; the router 0.1 of that; norms 1.
"""
from __future__ import annotations

import torch

CHUNK = 1 << 28          # elements a draw


def layout(run) -> list:
    """``(name, shape, std)`` of every leaf, in a fixed order; ``std`` 0
    means ones (a norm's weight)."""
    L, d, v = run["n_layers"], run["d_model"], run["vocab_size"]
    hd = run["n_heads"] * run["head_dim"]
    kvd = run["n_kv_heads"] * run["head_dim"]
    f = run["d_ff"]
    out = [("embed.tok", (v, d), 1.0),
           ("layers.norm1", (L, d), 0.0),
           ("layers.attn.wq", (L, d, hd), d ** -0.5),
           ("layers.attn.wk", (L, d, kvd), d ** -0.5),
           ("layers.attn.wv", (L, d, kvd), d ** -0.5),
           ("layers.attn.wo", (L, hd, d), hd ** -0.5),
           ("layers.norm2", (L, d), 0.0)]
    if run["n_experts"]:
        e = run["n_experts"]
        out += [("layers.moe.router", (L, d, e), 0.1 * d ** -0.5),
                ("layers.moe.wi", (L, e, d, 2 * f), d ** -0.5),
                ("layers.moe.wo", (L, e, f, d), f ** -0.5)]
    else:
        out += [("layers.mlp.wi", (L, d, 2 * f), d ** -0.5),
                ("layers.mlp.wo", (L, f, d), f ** -0.5)]
    out += [("final_norm", (d,), 0.0), ("head.w", (d, v), d ** -0.5)]
    return out


def leaf_seed(seed: int, index: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) \
        % (1 << 63)


def draw_leaf(run, seed: int, name: str, device, dtype) -> torch.Tensor:
    """One leaf, drawn as :func:`draw` draws it."""
    for i, (n, shape, std) in enumerate(layout(run)):
        if n == name:
            out = torch.empty(shape, dtype=dtype, device=device)
            if std == 0.0:
                return out.fill_(1.0)
            gen = torch.Generator(device=device).manual_seed(
                leaf_seed(seed, i))
            flat = out.view(-1)
            for a in range(0, flat.numel(), CHUNK):
                flat[a:a + CHUNK].normal_(0.0, std, generator=gen)
            return out
    raise KeyError(name)


def draw(run, seed: int, device, dtype) -> dict:
    """Every leaf: ``{name: tensor}``."""
    return {n: draw_leaf(run, seed, n, device, dtype)
            for n, _, _ in layout(run)}


def as_tree(flat: dict) -> dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}`` (the tensors shared)."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = t
    return tree


def tensor_seed(seed: int, stream: str) -> int:
    """A generator seed for one of a run's input streams (prompts, token
    batches), apart from every leaf's."""
    h = 1469598103934665603
    for ch in stream.encode():
        h = ((h ^ ch) * 1099511628211) % (1 << 64)
    return (seed * 0x2545F4914F6CDD1D + h) % (1 << 63)
