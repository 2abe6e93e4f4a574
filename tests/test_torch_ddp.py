"""The port's DDP gradient sync (``repro_torch.train.ddp``), its sweep
builders (``repro_torch.sweep``) and the paper entry point
(``repro_torch.launch.paper``) against the JAX package.

Numerics: one DDP step on a one-rank subgroup of the fake process group,
fed the global batch, against the reference's step on its 8-device mesh,
each device a shard: the parameters after the SGD update agree to
``1e-5`` (fp32 gradients summed in another order, scaled by the learning
rate).

Captures: the port's ``paper`` (4x2), ``resnet`` (4x2) and ``gnmt`` (8)
cells against the reference's traced (application-issued) collectives, per
kind ``(calls, payload bytes)``.  The reference scans GNMT's four steps, so
it traces one step's gradient all-reduces; the port's loop issues all
four, so the reference's all-reduces are weighted by the trip count.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import sweep as ref_sweep
from repro.compat import has_allreduce_combiner
from repro.core.export import serialize as ref_ser
from repro.data import synthetic as ref_data
from repro.models.gnmt import GNMT as RefGNMT
from repro.models.resnet import ResNet18 as RefResNet18
from repro.train import ddp as ref_ddp
from repro_torch import sweep
from repro_torch.core import MonitorSession
from repro_torch.core.interceptor import traced_summary
from repro_torch.launch import paper as launch
from repro_torch.models import GNMT, ResNet18
from repro_torch.models.common import tree_leaves
from repro_torch.train import ddp
from repro_torch.weights import from_jax_params
from torch_fixtures import mesh_4x2

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "translation_report.json"
PARAM_TOL = 1e-5
GNMT_STEPS = 4          # the gnmt cell's scanned steps (reference) / loop

# the reference's traced events of each cell, pinned: kind -> (calls, bytes)
REF_TRACED = {
    ("paper", "4x2"): {"AllReduce": (4, 2101252)},
    ("resnet", "4x2"): {"AllReduce": (17, 44873364)},
    ("gnmt", "8"): {"AllGather": (17, 1658896), "AllReduce": (2, 1658880)},
}
# the port's captures: the same, GNMT's all-reduces for all four steps
PORT_TRACED = {
    ("paper", "4x2"): {"AllReduce": (4, 2101252)},
    ("resnet", "4x2"): {"AllReduce": (17, 44873364)},
    ("gnmt", "8"): {"AllGather": (17, 1658896), "AllReduce": (8, 6635520)},
}


def _mlp_specs_ref(d):
    f32 = jnp.float32
    return {"w1": jax.ShapeDtypeStruct((d, 4 * d), f32),
            "b1": jax.ShapeDtypeStruct((4 * d,), f32),
            "w2": jax.ShapeDtypeStruct((4 * d, d), f32)}


TREES = {
    "mlp": (lambda: _mlp_specs_ref(256),
            lambda: sweep.mlp_specs(256)),
    "resnet18": (lambda: RefResNet18(100).shapes(),
                 lambda: ResNet18(100).specs()),
    "gnmt": (lambda: RefGNMT(4096, 256, 2).shapes(),
             lambda: GNMT(4096, 256, 2).specs()),
}


@pytest.mark.parametrize("bucket_mb", [1.0, 25.0])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_bucket_plan_matches_reference(tree, bucket_mb):
    ref_tree, port_tree = TREES[tree]
    want, _ = ref_ddp.bucket_plan(ref_tree(), bucket_mb)
    assert ddp.bucket_plan(port_tree(), bucket_mb) == want


def test_bucket_plan_sizes_leaves_as_fp32():
    f32 = {"a": torch.empty(300_000), "b": torch.empty(300_000)}
    bf16 = {k: v.bfloat16() for k, v in f32.items()}
    assert ddp.bucket_plan(f32, 2.0) == ddp.bucket_plan(bf16, 2.0) == [[0],
                                                                       [1]]


# ---------------------------------------------------------------------------
# one DDP step against the reference's 8-device step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def group1():
    """A one-rank subgroup of the fake process group: its all-reduce
    leaves the data as it is, the sum over one rank."""
    mesh_4x2()
    return dist.new_group([0])


def _mlp_loss_ref(params, batch):
    h = jnp.tanh(batch["x"] @ params["w1"] + params["b1"])
    return ((h @ params["w2"] - batch["y"]) ** 2).mean(), {}


def _case(name):
    """(reference loss_fn, port loss_fn, reference params, global batch)."""
    key = jax.random.PRNGKey(0)
    if name == "resnet18":
        model = RefResNet18(num_classes=10)
        batch = ref_data.SyntheticImageData(
            num_classes=10, global_batch=16, image_size=32).batch_at(0)
        return (model.loss_fn, ResNet18(10).loss_fn, model.init(key), batch,
                ResNet18(10))
    if name == "gnmt":
        model = RefGNMT(64, 32, 2)
        batch = ref_data.SyntheticSeq2Seq(
            vocab_size=64, src_len=6, tgt_len=6, global_batch=8).batch_at(0)
        return (model.loss_fn, GNMT(64, 32, 2).loss_fn, model.init(key),
                batch, GNMT(64, 32, 2))
    specs = sweep.mlp_specs(32)
    k1, k2 = jax.random.split(key)
    params = {"w1": jax.random.normal(k1, (32, 128)) / 32 ** 0.5,
              "b1": jnp.zeros((128,)),
              "w2": jax.random.normal(k2, (128, 32)) / 128 ** 0.5}
    x = np.random.default_rng(0).standard_normal((16, 32)).astype(np.float32)
    return (_mlp_loss_ref, sweep.mlp_loss, params,
            {"x": jnp.asarray(x), "y": jnp.asarray(np.sin(x))}, specs)


def _port_params(rparams, model):
    return from_jax_params(jax.tree.map(np.asarray, rparams), model,
                           device="cpu")


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["mlp", "resnet18", "gnmt"])
def test_ddp_step_matches_reference_mesh_step(name, group1, mesh_dp):
    rloss_fn, ploss_fn, rparams, batch, model = _case(name)
    rstep = ref_ddp.make_ddp_train_step(rloss_fn, mesh_dp, bucket_mb=1.0)
    rnew, _, rloss = rstep(rparams, ref_ddp.init_error_feedback(rparams),
                           batch)
    pparams = _port_params(rparams, model)
    pstep = ddp.make_ddp_train_step(ploss_fn, group1, bucket_mb=1.0)
    pnew, _, ploss = pstep(pparams, ddp.init_error_feedback(pparams),
                           _to_torch(batch))
    assert float(ploss) == pytest.approx(float(rloss), rel=1e-5)
    for r, p in zip(jax.tree.leaves(rnew), tree_leaves(pnew)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0,
                                   atol=PARAM_TOL)


def test_per_param_and_bucketed_agree(group1):
    _, loss_fn, rparams, batch, model = _case("resnet18")
    params, batch = _port_params(rparams, model), _to_torch(batch)
    out = {}
    for mode in ("per_param", "bucketed"):
        step = ddp.make_ddp_train_step(loss_fn, group1, mode=mode)
        out[mode] = step(params, None, batch)
    assert float(out["per_param"][2]) == pytest.approx(
        float(out["bucketed"][2]), rel=1e-6)
    for a, b in zip(tree_leaves(out["per_param"][0]),
                    tree_leaves(out["bucketed"][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_compression_close_and_error_feedback_nonzero(group1):
    _, loss_fn, rparams, batch, model = _case("resnet18")
    params, batch = _port_params(rparams, model), _to_torch(batch)
    ef = ddp.init_error_feedback(params)
    exact = ddp.make_ddp_train_step(loss_fn, group1)(params, ef, batch)
    p_comp, ef2, _ = ddp.make_ddp_train_step(loss_fn, group1, compress=True)(
        params, ef, batch)
    for a, b in zip(tree_leaves(exact[0]), tree_leaves(p_comp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-2,
                                   atol=1e-4)
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(ef2))
    # the bf16 wire halves the traced bytes of every bucket
    with MonitorSession(mesh=mesh_4x2()) as sess:
        for compress in (False, True):
            sess.capture(ddp.make_ddp_train_step(
                loss_fn, group1, compress=compress), params, ef, batch)
    full, half = (traced_summary(c.traced)["AllReduce"]["payload_bytes"]
                  for c in sess.captures)
    assert half - 4 == (full - 4) // 2       # the fp32 loss is not compressed


def test_mesh_specs_match_reference():
    for spec in ("8", "4x2", "2x2x2"):
        assert sweep.parse_mesh(spec) == ref_sweep.parse_mesh(spec)
        assert sweep.mesh_id(spec) == ref_sweep.mesh_id(spec)
    with pytest.raises(ValueError):
        sweep.parse_mesh("2x2x2x2")
    assert sorted(sweep.available_configs()) == [
        "gnmt", "paper", "qwen3_8b", "recurrentgemma_2b", "resnet", "serve"]
    assert all(ref_sweep.available_configs()[n].version == s.version
               for n, s in sweep.available_configs().items())


# ---------------------------------------------------------------------------
# captures against the reference's traced events
# ---------------------------------------------------------------------------
_REPORTS: dict = {}


def _port_report(name, spec):
    if (name, spec) not in _REPORTS:
        mesh = sweep.build_mesh(spec, device="cpu")
        _REPORTS[name, spec] = sweep._monitor_cell(
            sweep.available_configs()[name].build, mesh, name)
    return _REPORTS[name, spec]


def _ref_report(name, spec):
    if ("ref", name, spec) not in _REPORTS:
        mesh = ref_sweep.build_mesh(spec)
        _REPORTS["ref", name, spec] = ref_sweep._monitor_cell(
            ref_sweep.available_configs()[name].build(mesh), mesh, name,
            "ring")
    return _REPORTS["ref", name, spec]


def _kinds(summary):
    return {k: (row["calls"], row["payload_bytes"])
            for k, row in summary.items()}


@pytest.mark.parametrize("name,spec", sorted(REF_TRACED))
def test_capture_equals_reference_traced_events(name, spec):
    ref = _kinds(_ref_report(name, spec).traced_summary)
    assert ref == REF_TRACED[name, spec]
    if name == "gnmt":       # the scan body's all-reduces, once per step
        calls, nbytes = ref["AllReduce"]
        ref["AllReduce"] = (calls * GNMT_STEPS, nbytes * GNMT_STEPS)
    got = _kinds(_port_report(name, spec).traced_summary)
    assert got == ref == PORT_TRACED[name, spec]


def test_compiled_summary_difference_is_the_combiner():
    """The reference's compiled summary is not what the application
    issued: XLA's all-reduce combiner folds a step's bucket all-reduces
    (and the loss average) into one call.  Bytes agree: both summaries
    count a payload once per replica group, two data groups on 4x2 (so
    twice the traced bytes) and one on 8, and weight GNMT's scanned call
    by its four trips.  The all-gathers are not combined."""
    combined = has_allreduce_combiner()
    for (name, spec), ref_calls in {("paper", "4x2"): 1, ("resnet", "4x2"): 1,
                                    ("gnmt", "8"): GNMT_STEPS}.items():
        ref = _kinds(_ref_report(name, spec).compiled_summary)
        port = _kinds(_port_report(name, spec).compiled_summary)
        traced_calls, traced_bytes = PORT_TRACED[name, spec]["AllReduce"]
        groups = 2 if spec == "4x2" else 1
        assert port["all-reduce"] == (traced_calls, traced_bytes * groups)
        assert ref["all-reduce"][1] == port["all-reduce"][1]
        assert ref["all-reduce"][0] == (ref_calls if combined
                                        else traced_calls)
        if name == "gnmt":
            assert ref["all-gather"] == port["all-gather"] == (17, 13271168)


def test_paper_cell_on_a_pod_mesh_spans_pod_and_data():
    """On a (pod, data, model) mesh the gradient all-reduce runs over the
    flattened (pod, data) submesh: both of its groups, named as torch
    names the flattened dim."""
    rep = _port_report("paper", "2x2x2")
    assert _kinds(rep.traced_summary) == _kinds(
        _ref_report("paper", "2x2x2").traced_summary)
    for op in rep.compiled_ops:
        assert op.replica_groups == [[0, 2, 4, 6], [1, 3, 5, 7]]
        assert op.op_name.endswith("[pod_data]")


def _translation_report():
    """The translation fixture's fwd and bwd phases, in the port: GNMT
    (vocab 64, d 128) on an 8-way data mesh, each rank 4 of the 32
    sequences of 12 tokens, gradients bucketed at 1 MiB."""
    mesh = sweep.build_mesh("8", device="cpu")
    group = mesh.get_group("data")
    model = GNMT(vocab=64, d=128, layers=2)

    def fwd(params, batch):
        loss, _ = model.loss_fn(params, batch)
        return ddp.pmean(loss, group)

    def bwd(params, batch):
        _, grads = ddp.value_and_grad(model.loss_fn, params, batch)
        return ddp.allreduce_bucketed(grads, group, bucket_mb=1.0)[0]

    sess = MonitorSession(mesh=mesh, name="GNMT-MT")
    with sess.fake_mode:
        params = model.shapes(device="cpu")
        batch = {k: torch.empty((4, 12), dtype=torch.int32)
                 for k in ("src", "tgt", "labels")}
    with sess.phase("fwd"):
        sess.capture(fwd, params, batch)
    with sess.phase("bwd"):
        sess.capture(bwd, params, batch)
    return sess.report()


def test_translation_fixture_phases_reproduced(tmp_path):
    fixture = json.loads(FIXTURE.read_text())
    rep = _translation_report()
    for phase, pinned in (("fwd", (1, 4)), ("bwd", (3, 2564096))):
        want = {}
        for ev in fixture["traced"]:
            if ev["phase"] == phase:
                n = 4 * int(np.prod(ev["arg_shapes"][0]["dims"]))
                calls, nbytes = want.get("AllReduce", (0, 0))
                want["AllReduce"] = (calls + 1, nbytes + n)
        got = _kinds(traced_summary([ev for ev in rep.traced
                                     if ev.phase == phase]))
        assert got == want == {"AllReduce": pinned}
    # the port's report loads in the reference into identical views
    path = tmp_path / "translation.json"
    rep.save(str(path))
    back = ref_ser.report_from_dict(json.loads(path.read_text()))
    assert back.phase_names() == ["fwd", "bwd"]
    assert back.traced_summary == rep.traced_summary
    for phase in (None, "fwd", "bwd"):
        ours, theirs = rep.view(phase=phase), back.view(phase=phase)
        assert theirs.summary == ours.summary
        np.testing.assert_array_equal(theirs.matrix, ours.matrix)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("app", ["paper", "gnmt"])
def test_live_step_issues_the_monitored_allreduces(app, group1):
    """``train`` counts a live step's all-reduces with the interceptor;
    the capture of one step at the same sizes records as many."""
    a = launch.make_app(app)
    res = launch.train(a, group1, steps=2, device="cpu")
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    rep = launch.monitor(a, mesh_spec="8", device="cpu")
    assert res["allreduce_calls"] == rep.compiled_summary[
        "all-reduce"]["calls"]
    n_buckets = len(ddp.bucket_plan(a.specs, sweep.BUCKET_MB))
    assert res["allreduce_calls"] == n_buckets + (app != "gnmt")


def test_paper_entry_point_on_cpu(tmp_path):
    """``python -m repro_torch.launch.paper`` end to end on the CPU (a
    process of its own: it makes and destroys its process groups)."""
    path = tmp_path / "paper.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.paper", "--app", "paper",
         "--device", "cpu", "--steps", "3", "--report", str(path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300,
        check=True).stdout
    assert "[train] paper on cpu, 3 DDP steps" in out
    assert "4 all-reduces a step" in out and "comm matrix" in out
    ref = ref_ser.report_from_dict(json.loads(path.read_text()))
    assert ref.num_devices == 8
    assert _kinds(ref.traced_summary) == {"AllReduce": (4, 2101252)}


def test_entry_point_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--app", "paper"])
