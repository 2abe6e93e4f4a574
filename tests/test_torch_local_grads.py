"""Gradients through ``Sharder.local`` on a real mesh: 4 gloo ranks,
(data 2, model 2).

A local step (a kernel wrapper on local shards) hands each input's local
gradient back to DTensor with the input's placements unless told
otherwise.  A weight replicated over ``data`` but read by each rank's own
batch rows (every RMSNorm weight, the temporal conv's ``conv_w`` and
``conv_b``) then keeps one batch shard's gradient.  ``Sharder.local``
works the gradient placements out itself (``grad_placements_for``:
``Partial`` where a replicated input meets a sharded output), so the
backward reduces them.

Each case runs one reduced train step's loss and backward in fp32 (the
arch's ``TRAIN`` remat policy) on the 4-rank mesh and in one process, from
the same numpy-seeded parameters and batch, and holds every parameter
leaf's gradient to the one-process gradient within
``1e-5 * max(1, max|g|)`` of that leaf.

The same script runs the mesh under the Sharder's ``enable_sp`` rule
(``seq`` over ``model``: each rank holds half of every sequence), where a
shard that started its rotation, conv, scan or recurrence at position 0,
or a loss or routing group cut at a shard's edge, would not match; it also
holds the prefill's last-token logits and the cache it fills to one
process's.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5

# one rank: argv is (rank, port, arch, sp); rank 0 prints each leaf's
# error and scale as JSON, with sp the prefill's logits' and each cache
# leaf's too
RANK = """
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, {src!r})
from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.models.common import tree_paths, tree_unflatten
from repro_torch.parallel import Sharder

rank, port, arch = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sp = sys.argv[4] == "1"
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        rank=rank, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
torch.manual_seed(0)
torch.set_num_threads(1)
cfg = dataclasses.replace(configs.config(arch, reduced=True),
                          param_dtype="float32", compute_dtype="float32")
model = build_model(cfg)
remat = configs.train_config(arch).remat
rng = np.random.default_rng(11)
paths = tree_paths(model.shapes(device="cpu"))
leaves = []
for path, t in paths:
    v = rng.standard_normal(tuple(t.shape)) * 0.1
    if path[-1] in ("norm", "norm1", "norm2", "final_norm", "head_norm",
                    "q_norm", "k_norm"):
        v = 1.0 + v
    leaves.append(torch.from_numpy(v.astype(np.float32)))
params = tree_unflatten(model.shapes(device="cpu"), leaves)
axes = model.axes()
b, s = 4, 32
batch = {{"tokens": torch.from_numpy(rng.integers(
              0, cfg.vocab_size, (b, s)).astype(np.int32)),
          "labels": torch.from_numpy(rng.integers(
              0, cfg.vocab_size, (b, s)).astype(np.int32))}}

def grads(shd, params):
    loss, _ = model.loss_fn(params, batch, shd, remat=remat)
    loss.backward()
    return loss

one = tree_unflatten(params, [t.clone().requires_grad_() for t in leaves])
loss1 = grads(Sharder(), one)
shd = Sharder(mesh, enable_sp=sp)
dist_p = shd.shard_tree(one, axes)
dist_p = tree_unflatten(params, [t.detach().requires_grad_()
                                 for _, t in tree_paths(dist_p)])
loss4 = grads(shd, dist_p)
res = {{"loss": abs(loss4.full_tensor().item() - loss1.item()), "leaves": {{}}}}
for (path, a), (_, d) in zip(tree_paths(one), tree_paths(dist_p)):
    g1 = a.grad
    g4 = d.grad.full_tensor()
    res["leaves"]["/".join(map(str, path))] = [
        (g4 - g1).abs().max().item(), g1.abs().max().item()]
if sp:
    with torch.no_grad():
        prompt = {{"tokens": batch["tokens"]}}
        l1, c1 = model.prefill(params, prompt, Sharder(), max_len=48)
        l4, c4 = model.prefill(shd.shard_tree(params, axes), prompt, shd,
                               max_len=48)
    res["logits"] = [(l4.full_tensor() - l1).abs().max().item(),
                     l1.abs().max().item()]
    res["cache"] = {{}}
    for (path, a), (_, d) in zip(tree_paths(c1), tree_paths(c4)):
        d = d.full_tensor() if hasattr(d, "full_tensor") else d
        # the error and the leaf's scale; a bf16 leaf's error less one unit
        # in the last place of the larger value (an fp32 rounding
        # difference may flip one bf16 rounding)
        ulp = 0.0
        if a.dtype == torch.bfloat16:
            ulp = torch.maximum(a.float().abs(), d.float().abs()) * 2.0 ** -7
        err = ((d.float() - a.float()).abs() - ulp).clamp_min(0)
        res["cache"]["/".join(map(str, path))] = [
            err.max().item(), a.float().abs().max().item()]
if rank == 0:
    print(json.dumps(res))
dist.destroy_process_group()
"""


def run_ranks(arch: str, sp: bool = False) -> dict:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = RANK.format(src=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               arch, "1" if sp else "0"], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(4)]
    outs = [proc.communicate(timeout=300) for proc in procs]
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["qwen3_8b", "recurrentgemma_2b",
                                  "xlstm_1_3b"])
def test_gradients_on_a_gloo_mesh_match_one_process(arch):
    """Every parameter leaf's gradient of a reduced train step on the
    (data 2, model 2) gloo mesh against the one-process gradient, within
    ``1e-5 * max(1, max|g|)``; the loss within 1e-5."""
    res = run_ranks(arch)
    assert res["loss"] <= TOL, res["loss"]
    bad = {name: err for name, (err, scale) in res["leaves"].items()
           if not err <= TOL * max(1.0, scale)}
    assert not bad, bad
    names = set(res["leaves"])
    assert any("norm" in n for n in names), names


@pytest.mark.parametrize("arch", ["qwen3_8b", "recurrentgemma_2b",
                                  "xlstm_1_3b", "grok_1_314b"])
def test_sequence_parallel_on_a_gloo_mesh_matches_one_process(arch):
    """The same train step on the (data 2, model 2) gloo mesh under
    ``Sharder(mesh, enable_sp=True)``, each rank holding 16 of the 32
    positions: the loss within 1e-5 and every gradient leaf within
    ``1e-5 * max(1, max|g|)`` of one process's; then a prefill (max_len
    48): the last-token logits within ``1e-5 * max(1, max|logit|)`` and
    each cache leaf within ``1e-5 * max(1, max|x|)``, a bf16 leaf (the kv
    cache) after one unit in its last place (the one-process fp32 values
    may round to a neighbouring bf16 value).  Grok-1's 32-token sequence
    is one routing group split over the two ``model`` ranks."""
    res = run_ranks(arch, sp=True)
    assert res["loss"] <= TOL, res["loss"]
    bad = {name: err for name, (err, scale) in res["leaves"].items()
           if not err <= TOL * max(1.0, scale)}
    assert not bad, bad
    err, scale = res["logits"]
    assert err <= TOL * max(1.0, scale), res["logits"]
    assert res["cache"] and "len" in res["cache"]
    bad = {name: (err, scale) for name, (err, scale) in res["cache"].items()
           if not err <= TOL * max(1.0, scale)}
    assert not bad, bad
