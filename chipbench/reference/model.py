"""Plain decoder-only transformer in float32: the dense model and the
Mixture-of-Experts block, for the benchmark's correctness check.

It imports nothing of the program and takes nothing the program made: the
weights come from ``chipbench.weights`` (drawn from the seed, or the same
raw tensors the program was handed), the tokens from the cell's traffic.

What it computes, after the published descriptions the configurations
name (``chipbench/configs/*.json``), with the departures the
configurations list under ``assumed``:

* token embedding; per layer a pre-norm RMSNorm (``x * rsqrt(mean(x^2) +
  eps) * w``), grouped-query attention with rotary embeddings (half-split
  layout, positions from 0), causal, scaled by ``head_dim ** -0.5``, an
  output projection and a residual add; a second RMSNorm, then a SwiGLU
  MLP (``silu(x W_gate) * (x W_up) W_down``) or a MoE block, and a
  residual add; a final RMSNorm and an untied head.
* The MoE block: an fp32 router, softmax over the experts, the ``top_k``
  largest renormalised to sum to 1; tokens in groups (a row's prompt in
  groups of ``moe_group`` where that divides it, else whole; one token a
  group when it is decoded), each expert holding ``max(min_capacity,
  ceil(capacity_factor * top_k * group / experts))`` slots a group, filled
  choice-major (every token's first choice before any second choice, in
  token order); a choice past the last slot is dropped, and its gate
  weight with it.
* Weights are in the program's ``(in, out)`` layout: ``x @ W``; ``wi``
  holds the gate then the up projection along its last dim; query and kv
  heads are contiguous ``(head, head_dim)`` column blocks.

``mm`` is the matmul every linear layer goes through: float32 here (with
TF32 off, which the caller sets), or ``precision.fp8_matmul`` for the
control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")


def plain_mm(a, b):
    return a @ b


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x (B,S,H,dh) at positions 0..S-1: rotate the first half against the
    second."""
    s, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32,
                       device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, block: int = 256):
    """Causal GQA: q (B,S,H,dh), k/v (B,S,KV,dh); query head ``h`` reads
    kv head ``h // (H / KV)``.  Scores in blocks of query rows."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)       # (B,H,S,dh)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for a in range(0, s, block):
        e = min(s, a + block)
        sc = (q[:, :, a:e] @ k[:, :, :e].transpose(-1, -2)) * dh ** -0.5
        qpos = torch.arange(a, e, device=q.device)[:, None]
        kpos = torch.arange(e, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, NEG_INF)
        outs.append(torch.softmax(sc, dim=-1) @ v[:, :, :e])
    return torch.cat(outs, dim=2).transpose(1, 2)           # (B,S,H,dh)


def capacity(run, group: int) -> int:
    return max(run["min_capacity"], math.ceil(
        run["capacity_factor"] * run["top_k"] * group / run["n_experts"]))


def moe_groups(run, prompt: int, decoded: int = 0) -> list:
    """Group lengths along a row: the prompt in groups of ``moe_group``
    where that divides it (else one group), then each decoded token alone."""
    g = run["moe_group"]
    head = [g] * (prompt // g) if prompt % g == 0 else [prompt]
    return head + [1] * decoded


def route(x, router, run, groups):
    """``(gate (B,S,k), idx (B,S,k), keep (B,S,k))``: the renormalised
    top-k of the fp32 router, and which choices found a slot."""
    k, e = run["top_k"], run["n_experts"]
    probs = torch.softmax(x @ router, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    if k > 1:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.zeros_like(idx, dtype=torch.bool)
    start = 0
    for n in groups:
        sel = F.one_hot(idx[:, start:start + n], e)          # (B,n,k,E)
        # choice-major order: all first choices, then all second ...
        flat = sel.transpose(1, 2).reshape(sel.shape[0], n * k, e)
        pos = flat.cumsum(1) - flat
        slot = (pos * flat).sum(-1).reshape(sel.shape[0], k, n)
        keep[:, start:start + n] = (slot < capacity(run, n)).transpose(1, 2)
        start += n
    return gate, idx, keep


def moe(x, lw, run, groups, mm, routes=None):
    """x (B,S,d) -> (B,S,d); ``lw(name, e)`` gives expert ``e``'s fp32
    ``wi`` / ``wo``.  Appends the kept choices to ``routes`` if given."""
    b, s, d = x.shape
    gate, idx, keep = route(x, lw("router"), run, groups)
    if routes is not None:
        routes.append(torch.where(keep, idx, -1))
    xf = x.reshape(b * s, d)
    w = (gate * keep).reshape(b * s, -1)
    idx = idx.reshape(b * s, -1)
    keep = keep.reshape(b * s, -1)
    out = torch.zeros_like(xf)
    for e in range(run["n_experts"]):
        rows, choice = torch.nonzero((idx == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        h = mm(xf[rows], lw("wi", e))
        gt, up = h.chunk(2, dim=-1)
        y = mm(F.silu(gt) * up, lw("wo", e))
        out = out.index_add(0, rows, y * w[rows, choice][:, None])
    return out.reshape(b, s, d)


def layer(x, lw, run, groups, mm, routes=None):
    """One block: ``lw(name)`` gives this layer's fp32 weights."""
    b, s, d = x.shape
    h, kv, dh = run["n_heads"], run["n_kv_heads"], run["head_dim"]
    eps = run["norm_eps"]
    a = rms_norm(x, lw("norm1"), eps)
    q = rope(mm(a, lw("wq")).reshape(b, s, h, dh), run["rope_theta"])
    k = rope(mm(a, lw("wk")).reshape(b, s, kv, dh), run["rope_theta"])
    v = mm(a, lw("wv")).reshape(b, s, kv, dh)
    x = x + mm(attention(q, k, v).reshape(b, s, h * dh), lw("wo"))
    a = rms_norm(x, lw("norm2"), eps)
    if run["n_experts"]:
        return x + moe(a, lw, run, groups, mm, routes)
    hid = mm(a, lw("mlp_wi"))
    gt, up = hid.chunk(2, dim=-1)
    return x + mm(F.silu(gt) * up, lw("mlp_wo"))


NAMES = {"norm1": "layers.norm1", "norm2": "layers.norm2",
         "wq": "layers.attn.wq", "wk": "layers.attn.wk",
         "wv": "layers.attn.wv", "wo": "layers.attn.wo",
         "mlp_wi": "layers.mlp.wi", "mlp_wo": "layers.mlp.wo",
         "router": "layers.moe.router"}


def layer_weights(W, l: int):
    """``lw(name, expert=None)``: layer ``l`` of the stacked weights in
    ``W`` (a dict of ``path ->`` a stacked tensor or a list of its
    layers), as float32."""
    def lw(name, e=None):
        if e is not None:
            return W[f"layers.moe.{name}"][l][e].float()
        return W[NAMES[name]][l].float()
    return lw


def hidden(W, run, tokens, groups, mm=plain_mm, routes=None):
    """The final-normed hidden states (B,S,d) of ``tokens`` (B,S)."""
    x = W["embed.tok"][tokens].float()
    for l in range(run["n_layers"]):
        x = layer(x, layer_weights(W, l), run, groups, mm, routes)
    return rms_norm(x, W["final_norm"].float(), run["norm_eps"])


def logits(W, h, mm=plain_mm):
    return mm(h, W["head.w"].float())


def loss(W, run, tokens, labels, mm=plain_mm):
    """Mean token cross-entropy of ``labels`` (B,S) given ``tokens``."""
    h = hidden(W, run, tokens, moe_groups(run, tokens.shape[1]), mm)
    lg = logits(W, h, mm)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))


@torch.no_grad()
def served_logits(W, run, prompts, served, mm=plain_mm, routes=None,
                  rows: int = 0):
    """Teacher-forced over each prompt and its served tokens: the logits
    (N, o, V) that chose served token ``j``, from position ``P - 1 + j``.
    The prompt's MoE groups are the prefill's, each served token's its
    own, as the served path groups them.  ``rows`` requests at a time
    (0: all); ``routes`` collects each block's kept choices a layer."""
    n, p = prompts.shape
    o = served.shape[1]
    full = torch.cat([prompts, served[:, :-1]], dim=1)
    groups = moe_groups(run, p, o - 1)
    rows = rows or n
    out = []
    for a in range(0, n, rows):
        blk = [] if routes is not None else None
        h = hidden(W, run, full[a:a + rows], groups, mm, blk)
        out.append(logits(W, h[:, p - 1:], mm))
        if routes is not None:
            routes.append(blk)
    return torch.cat(out)
