"""The port's user examples (``examples/torch_*.py``) against the
reference's (``examples/*.py``) on the CPU.

Each example runs through its ``main(argv)`` with ``--device cpu``, loaded
with ``importlib``, in a temporary working directory (nothing is written
under the repo).  The two training examples open and destroy a process
group of their own (gloo on the CPU), which the process-global fake group
of the captures forbids, so they run in a subprocess each; the capture
examples run in this process on the fake group of 8 ranks.

Each capture is held against the reference's capture of the same program:

* quickstart -- the port's ``monitor_fn`` report of the tensor-parallel
  MLP's value and gradients beside the reference's ``monitor_fn`` of the
  same ShapeDtypeStructs and shardings, per kind (calls, payload bytes),
  pinned side by side (the layouts differ, see ``PORT_QUICKSTART``);
* image classification -- the all-reduces of one live step equal the
  psums the reference's ``CollectiveInterceptor`` counts for the same
  ResNet-18 at 25 MiB, and the model learns;
* translation -- the three phases' application-issued tables equal the
  reference session's phase for phase; the issued tables differ only by
  XLA's all-reduce combiner (ROADMAP pinned difference 9);
* serve_lm -- the two phases' tables beside the reference's two-phase
  session on the same reduced config and 4x2 mesh, pinned side by side.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro import sweep as ref_sweep
from repro.compat import has_allreduce_combiner
from repro_torch import cli
from repro_torch.core import CommReport
from repro_torch.core.interceptor import traced_summary
from test_torch_imports import FORBIDDEN, _imported_modules
from torch_fixtures import mesh_4x2, ref_serve_cell

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "image_classification", "translation", "serve_lm")


def _load(name: str):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_main(name: str, argv: list, cwd: Path) -> tuple[dict, str]:
    """``main(argv)`` of ``examples/torch_<name>.py`` in a subprocess of its
    own (two torch threads), in ``cwd``; returns what it returned, a
    returned report as its per-phase tables (``traced``: the application's
    calls, ``issued``), and the output.  The process fails (and so the
    test) on any exception."""
    path = ROOT / "examples" / f"torch_{name}.py"
    code = (
        "import importlib.util, json, torch\n"
        "from repro_torch.core.interceptor import traced_summary\n"
        "torch.set_num_threads(2)\n"
        f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
        "ex = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(ex)\n"
        f"res = ex.main({argv!r})\n"
        "rep = res.pop('report', None)\n"
        "if rep is not None:\n"
        "    res['traced'] = {ph: traced_summary([e for e in rep.traced\n"
        "                                         if e.phase == ph])\n"
        "                     for ph in rep.phase_names()}\n"
        "    res['issued'] = rep.phase_summaries()\n"
        "print(json.dumps(res))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stdout


def _kinds(summary) -> dict:
    return {k: (r["calls"], r["payload_bytes"]) for k, r in summary.items()}


def _phase_kinds(rep) -> dict:
    return {ph: _kinds(s) for ph, s in rep.phase_summaries().items()}


# ---------------------------------------------------------------------------
# every example
# ---------------------------------------------------------------------------
EXAMPLE_FILES = sorted((ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", EXAMPLE_FILES,
                         ids=[p.name for p in EXAMPLE_FILES])
def test_example_imports_neither_jax_nor_the_reference(path):
    bad = [n for n in _imported_modules(path)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_every_reference_example_has_a_port():
    ref = {p.stem for p in (ROOT / "examples").glob("*.py")
           if not p.stem.startswith("torch_")}
    assert {p.stem[len("torch_"):] for p in EXAMPLE_FILES} == ref
    assert set(EXAMPLES) | {"moe_skew"} == ref


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_a_missing_gpu(name):
    """The default device is ``cuda``; without one the example raises
    before it opens a process group or builds a mesh, and never runs on
    the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
# kind -> (calls, payload bytes summed over replica groups) of the issued
# collectives.  GSPMD all-reduces the product over ``model`` where it is
# made (y = h @ w2, 4 groups of 512 KiB) and folds the gradients' and the
# loss's all-reduces over ``data`` into one (XLA's combiner: 2 groups of
# two 8 MiB gradient shards and the 4-byte loss).  DTensor keeps y
# ``Partial`` until ``y ** 2`` needs it whole: a reduce-scatter over
# ``model`` there and an all-gather of its gradient in the backward, each
# twice (the square's two operands); the loss's average is one all-reduce
# a mesh dimension (``Partial(avg)`` over both), and each gradient its own
# all-reduce over ``data``.  The gradients' bytes are the reference's.
REF_QUICKSTART = {"all-reduce": (2, 35651592)}
PORT_QUICKSTART = {"all-reduce": (4, 33554456),
                   "reduce-scatter": (2, 4194304),
                   "all-gather": (2, 4194304)}


def _ref_quickstart():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import make_mesh
    from repro.core import monitor_fn

    mesh = make_mesh((4, 2), ("data", "model"))

    def train_step(w1, w2, x):
        h = jax.nn.relu(x @ w1)
        return ((h @ w2) ** 2).mean()

    shard = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
    return monitor_fn(
        jax.value_and_grad(train_step, argnums=(0, 1)),
        jax.ShapeDtypeStruct((1024, 4096), jnp.float32),
        jax.ShapeDtypeStruct((4096, 1024), jnp.float32),
        jax.ShapeDtypeStruct((512, 1024), jnp.float32),
        mesh=mesh, name="quickstart",
        in_shardings=(shard(None, "model"), shard("model", None),
                      shard("data", None)))


def test_quickstart_beside_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    mesh_4x2()
    rep, rl = _load("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    ref = _ref_quickstart()
    assert _kinds(ref.compiled_summary) == REF_QUICKSTART
    assert _kinds(rep.compiled_summary) == PORT_QUICKSTART
    # the gradients' all-reduces carry the reference's bytes: its combined
    # data all-reduce less the 4-byte loss, over its 2 groups
    grads = [op for op in rep.compiled_ops
             if op.kind == "all-reduce" and op.payload_bytes > 4]
    assert [op.payload_bytes for op in grads] == [1024 * 2048 * 4] * 2
    assert sum(op.payload_bytes for op in grads) * 2 == (
        REF_QUICKSTART["all-reduce"][1] - 4 * 524288 - 2 * 4)
    # nothing application-issued in either: the collectives are the
    # layouts' own
    assert not ref.traced_summary
    assert rl.collective_s > 0 and rl.compute_s > 0 and rl.memory_s > 0
    assert "roofline: compute" in out and "dominant=" in out
    for suffix in (".json", ".html", ".trace.json"):
        assert (tmp_path / "artifacts" /
                f"torch_quickstart_report{suffix}").stat().st_size > 0
    again = CommReport.load(str(tmp_path / "artifacts" /
                                "torch_quickstart_report.json"))
    assert _kinds(again.compiled_summary) == PORT_QUICKSTART


def test_quickstart_through_the_cli_script_route(tmp_path, monkeypatch,
                                                  capsys):
    """``python -m repro_torch monitor examples/torch_quickstart.py``: the
    script runs as ``__main__``; its own ``--device`` goes after ``--``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    mesh_4x2()
    rc = cli.main(["monitor", str(ROOT / "examples" / "torch_quickstart.py"),
                   "--", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "### CommReport: quickstart (8 devices) ###" in out
    assert "roofline: compute" in out


# ---------------------------------------------------------------------------
# image classification
# ---------------------------------------------------------------------------
def _ref_resnet_psums(classes: int, image_size: int) -> int:
    """The psums the reference's interceptor counts in one lowered DDP
    step of ResNet-18 (bucketed at 25 MiB), as its example does."""
    from repro.compat import make_mesh
    from repro.core import CollectiveInterceptor
    from repro.data import SyntheticImageData
    from repro.models.resnet import ResNet18
    from repro.train import ddp

    mesh = make_mesh((8,), ("data",))
    model = ResNet18(num_classes=classes)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    ef = jax.eval_shape(ddp.init_error_feedback, params)
    step = ddp.make_ddp_train_step(model.loss_fn, mesh, mode="bucketed",
                                   bucket_mb=25.0, lr=5e-2)
    data = SyntheticImageData(num_classes=classes, global_batch=32,
                              image_size=image_size)
    with CollectiveInterceptor(mesh=mesh) as icpt:
        step.lower(params, ef, data.batch_at(0))
    return sum(1 for e in icpt.events if e.primitive == "psum")


def test_image_classification_learns_and_counts_the_reference_psums(
        tmp_path):
    res, out = _run_main("image_classification",
                         ["--steps", "30", "--image-size", "16",
                          "--device", "cpu"], tmp_path)
    assert res["acc"] > 0.5
    assert len(res["losses"]) == 30 and len(res["step_ms"]) == 29
    # two 25 MiB gradient buckets and the loss average
    assert res["allreduce_calls"] == _ref_resnet_psums(8, 16) == 3
    assert "AllReduce calls per step (bucketed, 25 MiB): 3" in out
    assert "one epoch of 30 steps issues 90 AllReduce calls" in out
    assert "image classification example OK" in out


# ---------------------------------------------------------------------------
# translation
# ---------------------------------------------------------------------------
# phase -> kind -> (calls, payload bytes): the application-issued
# all-reduces, the same in both packages (the loss average; three 1 MiB
# gradient buckets)
TRANSLATION_TRACED = {"fwd": {"AllReduce": (1, 4)},
                      "bwd": {"AllReduce": (3, 2564096)},
                      "optim": {}}


def _ref_translation_session():
    """The reference example's three-phase session (its capture half)."""
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    from repro.core import MonitorSession
    from repro.data import SyntheticSeq2Seq
    from repro.models.gnmt import GNMT
    from repro.optim import OptConfig, apply_updates, init_opt_state
    from repro.train import ddp

    mesh = make_mesh((8,), ("data",))
    model = GNMT(vocab=64, d=128, layers=2)
    params = model.init(jax.random.PRNGKey(0))
    data = SyntheticSeq2Seq(vocab_size=64, src_len=12, tgt_len=12,
                            global_batch=32)
    ocfg = OptConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=500)
    opt = init_opt_state(params, ocfg)

    def fwd(params, batch):
        loss, _ = model.loss_fn(params, batch)
        return jax.lax.pmean(loss, "data")

    def bwd(params, batch):
        _, grads = jax.value_and_grad(model.loss_fn, has_aux=True)(
            params, batch)
        return ddp.allreduce_bucketed(grads, "data", bucket_mb=1.0)[0]

    def optim(params, grads, opt, i):
        params, opt, _ = apply_updates(params, grads, opt, ocfg, i)
        return params, opt

    def dp(fn, in_specs, out_specs):
        return shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)

    batch = data.batch_at(0)
    session = MonitorSession(mesh=mesh, name="GNMT-MT")
    with session.phase("fwd"):
        session.capture(dp(fwd, (P(), P("data")), P()), params, batch)
    with session.phase("bwd"):
        session.capture(dp(bwd, (P(), P("data")), P()), params, batch)
    with session.phase("optim"):
        session.capture(dp(optim, (P(), P(), P(), P()), (P(), P())),
                        params, params, opt, jnp.asarray(0))
    return session.report()


def _traced_by_phase(rep) -> dict:
    return {ph: _kinds(traced_summary([e for e in rep.traced
                                       if e.phase == ph]))
            for ph in rep.phase_names()}


def _tuples(tables: dict) -> dict:
    """Per-phase tables read back from JSON: (calls, bytes) tuples."""
    return {ph: _kinds(t) for ph, t in tables.items()}


def test_translation_learns_and_its_phases_match_the_reference(tmp_path):
    res, out = _run_main("translation", ["--device", "cpu"], tmp_path)
    losses = res["losses"]
    assert len(losses) == 150 and losses[-1] < 0.7 * losses[0]
    assert "translation example OK" in out
    assert "phase optim: no collective communication" in out
    ref = _ref_translation_session()
    assert ref.phase_names() == ["fwd", "bwd", "optim"]
    assert _tuples(res["traced"]) == _traced_by_phase(ref) \
        == TRANSLATION_TRACED
    # issued: the port issues what the application did; XLA's combiner
    # folds the three bucket all-reduces into one (bytes equal)
    port, want = _tuples(res["issued"]), _phase_kinds(ref)
    assert port["bwd"] == {"all-reduce": (3, 2564096)}
    assert want["bwd"] == {"all-reduce": (
        1 if has_allreduce_combiner() else 3, 2564096)}
    assert port["fwd"] == want["fwd"] == {"all-reduce": (1, 4)}
    assert port.get("optim", {}) == want.get("optim", {}) == {}
    # the saved report loads with its three phases and their tables
    saved = CommReport.load(str(tmp_path / "artifacts" /
                                "torch_translation_report.json"))
    assert saved.phase_names() == ["fwd", "bwd", "optim"]
    assert _phase_kinds(saved) == port


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------
# (phase, kind) -> (calls, payload bytes per device) of the reduced
# Qwen3-8B serve step, batch 8, prompt 32, cache 36 (4 new tokens), on a
# 4x2 mesh.  The port's is the CPU mesh's: DTensor's all-to-all falls back
# to all-gather + chunk there.  The two differ as the serve cell always
# has (ROADMAP pinned difference 6; tests/test_torch_session.py pins the
# port's cache-48 table): DTensor gathers the SwiGLU hidden dim for its
# ``chunk`` and the token ids over ``data``, and q/k/v end in
# reduce-scatters; GSPMD's compiled step moves activations between the 4
# layers' shards with collective-permutes (2 a layer) and issues no
# reduce-scatter.
PORT_SERVE = {
    "prefill": {"all-gather": (39, 1939456), "all-reduce": (9, 294912),
                "reduce-scatter": (1, 8192)},
    "decode": {"all-gather": (51, 131200), "all-reduce": (17, 18432),
               "reduce-scatter": (17, 57344)},
}
REF_SERVE = {
    "prefill": {"all-gather": (8, 524288), "all-reduce": (8, 262144),
                "collective-permute": (8, 262144)},
    "decode": {"all-gather": (12, 24576), "all-reduce": (20, 13312),
               "collective-permute": (8, 8192)},
}


def test_serve_lm_beside_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    mesh_4x2()
    res = _load("serve_lm").main(["--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert tuple(res["tokens"].shape) == (8, 4)
    assert res["tokens_per_s"] > 0
    assert "serving example OK" in out and "sample completion ids" in out
    rep = res["report"]
    assert rep.phase_names() == ["prefill", "decode"]
    cfg = ref_configs.config("qwen3_8b", reduced=True)
    mesh = ref_sweep.build_mesh("4x2")
    ref = ref_sweep._monitor_cell(ref_serve_cell(cfg, max_len=36)(mesh),
                                  mesh, "serve", "ring")
    assert _phase_kinds(rep) == PORT_SERVE
    assert _phase_kinds(ref) == REF_SERVE
