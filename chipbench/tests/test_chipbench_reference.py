"""The plain reference against the port at small sizes on the CPU, both in
float32: the dense and MoE forward passes (capacity drops included), the
loss and its gradients, served tokens through the cache, and AdamW.
This test, not the reference, imports both."""
from __future__ import annotations

import ast

import pytest
import torch

from chipbench import port, weights
from chipbench.reference import adamw
from chipbench.reference import model as ref

from .conftest import ROOT, TINY

DENSE = dict(TINY, arch="granite_3_2b", n_experts=0, top_k=0,
             capacity_factor=1.25, moe_group=512, min_capacity=4,
             norm_eps=1e-6, rope_theta=10000.0, tie_embeddings=False,
             param_dtype="float32", compute_dtype="float32")
# capacity factor 0.5: 16 slots an expert for a group of 64 tokens' 128
# choices over 4 experts, so choices are dropped
MOE = dict(DENSE, arch="grok_1_314b", n_experts=4, top_k=2,
           capacity_factor=0.5)


def port_model(run):
    from repro_torch.models import build_model
    return build_model(port.model_config(run))


def tokens(b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 512, (b, s), generator=g)


@pytest.mark.parametrize("run", [DENSE, MOE], ids=["dense", "moe"])
def test_prefill_logits_match(run):
    from repro_torch.parallel import Sharder
    W = weights.draw(run, 5, "cpu", torch.float32)
    t = tokens(3, 64)
    with torch.no_grad():
        got, _ = port_model(run).prefill(weights.as_tree(W), {"tokens": t},
                                         Sharder(), max_len=72)
        routes = []
        want = ref.logits(W, ref.hidden(W, run, t, ref.moe_groups(run, 64),
                                        routes=routes))[:, -1]
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    if run["n_experts"]:
        dropped = sum(int((r < 0).sum()) for r in routes)
        assert dropped > 0


@pytest.mark.parametrize("run", [DENSE, MOE], ids=["dense", "moe"])
def test_loss_and_gradients_match(run):
    from repro_torch.parallel import Sharder
    W = weights.draw(run, 6, "cpu", torch.float32)
    t = tokens(2, 64, 1)
    params = weights.as_tree({n: w.clone().requires_grad_()
                              for n, w in W.items()})
    model = port_model(run)
    got, metrics = model.loss_fn(params, {"tokens": t[:, :-1],
                                          "labels": t[:, 1:]}, Sharder(),
                                 remat="none")
    xent = metrics["xent"]
    Wr = {n: w.clone().requires_grad_() for n, w in W.items()}
    want = ref.loss(Wr, run, t[:, :-1], t[:, 1:])
    torch.testing.assert_close(xent, want, atol=1e-5, rtol=1e-5)
    xent.backward()
    want.backward()
    for n in W:
        node = params
        for p in n.split("."):
            node = node[p]
        torch.testing.assert_close(node.grad, Wr[n].grad, atol=2e-5,
                                   rtol=1e-3, msg=n)


@pytest.mark.parametrize("run", [DENSE, MOE], ids=["dense", "moe"])
def test_served_tokens_are_the_references_best(run):
    """Greedy tokens through the port's cache are, at each position, the
    reference's full forward pass's best, and its logits agree."""
    from repro_torch.parallel import Sharder
    from repro_torch.serve import generate
    W = weights.draw(run, 7, "cpu", torch.float32)
    prompts = tokens(4, 16, 2)
    served = generate(port_model(run), weights.as_tree(W), prompts,
                      Sharder(), steps=6, max_len=22)
    lg = ref.served_logits(W, run, prompts, served, rows=3)
    assert lg.shape == (4, 6, 512)
    gap = lg.max(-1).values - lg.gather(-1, served[..., None])[..., 0]
    assert float(gap.max()) < 1e-4


def test_groups_follow_the_served_path():
    assert ref.moe_groups(MOE, 1024, 3) == [512, 512, 1, 1, 1]
    assert ref.moe_groups(MOE, 256, 2) == [256, 1, 1]
    assert ref.capacity(MOE, 1) == 4
    assert ref.capacity(dict(MOE, capacity_factor=1.25, n_experts=8),
                        512) == 160


def test_adamw_matches_the_port():
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    h = dict(peak_lr=3e-4, warmup_steps=10, decay_steps=100,
             min_lr_ratio=0.1, b1=0.9, b2=0.95, eps=1e-8,
             weight_decay=0.1, grad_clip=1.0)
    cfg = OptConfig(name="adamw", **h)
    g = torch.Generator().manual_seed(3)
    p0 = {"a": torch.randn(8, 16, generator=g),
          "b": torch.randn(16, generator=g)}
    ours = {k: v.clone() for k, v in p0.items()}
    theirs = {k: v.clone() for k, v in p0.items()}
    opt = init_opt_state(theirs, cfg)
    state: dict = {}
    for t in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in
                 p0.items()}
        clip = adamw.clip_factor(h, grads)
        adamw.step(ours, grads, state, h, t, clip)
        apply_updates(theirs, grads, opt, cfg, t)
    for k in p0:
        torch.testing.assert_close(ours[k], theirs[k], atol=1e-6, rtol=1e-6)
        assert not torch.equal(ours[k], p0[k])


def test_lr_schedule():
    h = dict(peak_lr=3e-4, warmup_steps=10, decay_steps=100,
             min_lr_ratio=0.1)
    assert adamw.lr_at(h, 0) == pytest.approx(3e-5)
    assert adamw.lr_at(h, 9) == pytest.approx(3e-4)
    assert adamw.lr_at(h, 100) == pytest.approx(3e-5)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "chipbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in ("torch", "math", "__future__",
                                              ""), (path.name, name)


def test_weights_redraw_bit_for_bit():
    a = weights.draw_leaf(MOE, 11, "layers.moe.wi", "cpu", torch.bfloat16)
    b = weights.draw_leaf(MOE, 11, "layers.moe.wi", "cpu", torch.bfloat16)
    c = weights.draw_leaf(MOE, 12, "layers.moe.wi", "cpu", torch.bfloat16)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 4, 64, 256)
