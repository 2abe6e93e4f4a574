"""The port's capture (``MonitorSession`` over a fake process group) and its
reports, against the reference.

The reduced ``qwen3_8b`` serve step (and, at the end of the file, the
reduced ``recurrentgemma_2b`` one) is captured in two phases, prefill and
decode, on a fake 4x2 (data x model) mesh at the sizes of the committed
``tests/fixtures/serve_report.json`` (batch 8, prompt 32, cache 56).  Reports
must cross-load in both directions with identical summaries and matrices.

The port's collective profile is pinned here, and it is not GSPMD's.  The
fixture holds what XLA chose for the same step: all-to-alls and
collective-permutes (it shards the KV cache by sequence and reshards
activations between sequence and heads) and bf16 all-reduces, counted once per
scanned layer with an execution weight.  DTensor follows the port's
placements op by op instead: FSDP all-gathers of each data-sharded weight at
use, Megatron-style all-reduces of the row-parallel attention and MLP outputs
over ``model``, all-gathers of the vocab-sharded logits, and reduce-scatters
where a data-partial product goes back to batch-sharded rows.  Both shard
the cache by sequence (``kv_seq``): the port's prefill reshards each
layer's filled cache from kv heads to sequence shards, and its decode
gathers q, k and v to all heads and merges the sequence shards' partials
with two fp32 all-reduces a layer over ``model``; no permutes appear, and
an eager program unrolls its layers, so every op has weight 1.  The table is a CPU mesh's:
there DTensor's shard-to-shard redistribution issues all-gather plus a
local chunk, where on a ``cuda`` mesh (the serving entry point's default)
it issues ``_dtensor.shard_dim_alltoall``, recorded as an all-to-all.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.export import serialize as ref_ser
from repro.core.monitor import CommReport as RefReport
from repro_torch import configs
from repro_torch.core import CommReport, MonitorSession, monitor_fn
from repro_torch.core.export import serialize as ser
from repro_torch.core.interceptor import CollectiveInterceptor
from repro_torch.launch import serve as launch
from torch_fixtures import mesh_4x2

FIXTURE = Path(__file__).parent / "fixtures" / "serve_report.json"

# the port's per-phase profile of the reduced serve step on a CPU 4x2 mesh:
# (phase, kind) -> (calls, payload bytes per device)
PINNED = {
    ("prefill", "all-gather"): (39, 2103296),
    ("prefill", "all-reduce"): (9, 294912),
    ("prefill", "reduce-scatter"): (1, 8192),
    ("decode", "all-gather"): (51, 131200),
    ("decode", "all-reduce"): (17, 18432),
    ("decode", "reduce-scatter"): (17, 57344),
}
# kinds the reference's GSPMD capture of the same step has and the port's
# capture on a CPU mesh has not.  On a ``cuda`` mesh, the serving entry
# point's default, the port does issue all-to-alls (DTensor's
# shard_dim_alltoall, 290 / 218 a phase at full width): chip_smoke.py holds that
# capture's per-phase calls to its own pinned table
GSPMD_ONLY_ON_CPU_MESH = {"all-to-all", "collective-permute"}

# the same for the reduced RecurrentGemma serve step (6 layers: two
# (rec, rec, attn) superblocks), same mesh and sizes
PINNED_GRIFFIN = {
    ("prefill", "all-gather"): (45, 2406400),
    ("prefill", "all-reduce"): (17, 557056),
    ("prefill", "reduce-scatter"): (9, 532480),
    ("decode", "all-gather"): (59, 161920),
    ("decode", "all-reduce"): (21, 22016),
    ("decode", "reduce-scatter"): (29, 88064),
}

_REPORT: dict = {}


def _serve_report(arch: str = "qwen3_8b") -> CommReport:
    if arch not in _REPORT:
        mesh_4x2()
        cfg = configs.config(arch, reduced=True)
        _REPORT[arch] = launch.monitor(cfg, mesh_shape=(4, 2), batch=8,
                                       prompt_len=32, tokens=24,
                                       device="cpu")
    return _REPORT[arch]


def _table(rep) -> dict:
    return {(ph, kind): (row["calls"], row["payload_bytes"])
            for ph, summ in rep.phase_summaries().items()
            for kind, row in summ.items()}


def test_two_phase_profile_is_pinned():
    rep = _serve_report()
    assert rep.phase_names() == ["prefill", "decode"]
    got = _table(rep)
    assert got == PINNED
    assert all(op.weight == 1.0 for op in rep.compiled_ops)
    ref_kinds = {op["kind"] for op in json.loads(FIXTURE.read_text())["ops"]}
    assert GSPMD_ONLY_ON_CPU_MESH <= ref_kinds
    assert not GSPMD_ONLY_ON_CPU_MESH & {kind for _, kind in got}


def test_ops_carry_mesh_groups_and_per_device_shapes():
    rep = _serve_report()
    data_groups = [[0, 2, 4, 6], [1, 3, 5, 7]]
    model_groups = [[0, 1], [2, 3], [4, 5], [6, 7]]
    for op in rep.compiled_ops:
        axis = op.op_name.rsplit("[", 1)[1].rstrip("]")
        assert op.replica_groups == {"data": data_groups,
                                     "model": model_groups}[axis]
        # bf16 activations and weights; the int64 token ids are gathered
        # over data where the embedding lookup meets the data-sharded table;
        # the decode's log-sum-exp merge over model is fp32
        # (batch 8 over data 4, 4 heads; the packed output 16 + 1 wide)
        merge = (op.phase == "decode" and op.kind == "all-reduce"
                 and op.result_shapes[0].dims in ((2, 4), (2, 4, 17)))
        assert op.result_shapes and all(
            s.dtype in (("f32",) if merge else ("bf16", "s64"))
            for s in op.result_shapes)
    # prefill all-reduces over model: the vocab-sharded embedding lookup's
    # partial sums (batch 8, seq 32, d_model 64 over data 4), then per layer
    # the row-parallel attention and MLP outputs (batch 8 over data 4)
    ar = [op.result_shapes[0].dims for op in rep.compiled_ops
          if op.phase == "prefill" and op.kind == "all-reduce"]
    assert ar == [(8, 32, 16)] + [(2, 32, 64)] * 8


def test_port_report_loads_in_the_reference(tmp_path):
    rep = _serve_report()
    path = tmp_path / "port.json"
    rep.save(str(path))
    d = json.loads(path.read_text())
    assert d["schema"] == "repro.comm_report.v9"
    assert not {"hlo_gz", "schedules", "lint"} & set(d)
    ref = ref_ser.report_from_dict(d)
    assert ref.compiled_summary == rep.compiled_summary
    assert ref.view().summary == rep.compiled_summary
    assert np.array_equal(ref.matrix, rep.matrix)
    assert np.array_equal(ref.view(phase="decode").matrix,
                          rep.view(phase="decode").matrix)
    assert ref.phase_names() == rep.phase_names()
    back = CommReport.load(str(path))
    assert back.compiled_summary == rep.compiled_summary
    assert np.array_equal(back.matrix, rep.matrix)


def test_reference_report_loads_in_the_port():
    d = json.loads(FIXTURE.read_text())
    ref = RefReport.load(str(FIXTURE))
    rep = ser.report_from_dict(d)
    assert rep.phase_names() == ref.phase_names() == ["prefill", "decode"]
    assert rep.compiled_summary == ref.compiled_summary
    assert np.array_equal(rep.matrix, ref.matrix)
    # recomputed from the ops by both packages, not read back from the file
    for alg, phase in (("ring", "prefill"), ("ring", "decode"),
                       ("tree", None), ("hierarchical", "decode")):
        assert rep.view(alg, phase).summary == ref.view(alg, phase).summary
        assert np.array_equal(rep.view(alg, phase).matrix,
                              ref.view(alg, phase).matrix)


def test_render_and_heatmap():
    rep = _serve_report()
    text = rep.render()
    assert "per-phase collectives" in text and "comm matrix" in text
    heat = rep.heatmap(phase="decode")
    assert heat.splitlines()[0].endswith("[phase decode] ==")


def test_op_transform_and_monitor_fn():
    mesh = mesh_4x2()

    def fn(t):
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        x = distribute_tensor(t, mesh, (Shard(0), Shard(1)),
                              src_data_rank=None)
        return x.redistribute(mesh, (Replicate(), Replicate()))

    def double(op):
        op.weight = 2.0
        return op

    sess = MonitorSession(mesh=mesh, name="t")
    with sess.fake_mode:
        t = torch.empty(8, 4)
    cap = sess.capture(fn, t, op_transform=double)
    assert [op.kind for op in cap.ops] == ["all-gather", "all-gather"]
    assert all(op.weight == 2.0 and op.phase == "main" for op in cap.ops)
    rep = monitor_fn(fn, t, mesh=mesh, name="gather")
    assert rep.compiled_summary["all-gather"]["calls"] == 2


class TestInPlaceCollectives:
    """``torch.distributed``'s in-place API reaches the ``c10d`` ops with
    list operands; ``wait_tensor`` is no collective."""

    def _record(self, fn):
        mesh_4x2()
        with CollectiveInterceptor() as icpt:
            fn()
        return icpt.ops

    @pytest.mark.parametrize("call,kind,dims", [
        (lambda t: dist.all_reduce(t), "all-reduce", (4, 6)),
        (lambda t: dist.broadcast(t, 0), "collective-broadcast", (4, 6)),
        (lambda t: dist.all_gather([torch.empty_like(t) for _ in range(8)],
                                   t), "all-gather", (32, 6)),
        (lambda t: dist.all_gather_into_tensor(
            torch.empty(32, 6, dtype=t.dtype), t), "all-gather", (32, 6)),
        (lambda t: dist.reduce_scatter_tensor(
            torch.empty(1, 6, dtype=t.dtype),
            torch.empty(8, 6, dtype=t.dtype)), "reduce-scatter", (1, 6)),
    ])
    def test_recorded_with_world_group(self, call, kind, dims):
        t = torch.ones(4, 6, dtype=torch.bfloat16)
        ops = self._record(lambda: call(t))
        assert [op.kind for op in ops] == [kind]
        assert ops[0].result_shapes[0].dims == dims
        assert ops[0].result_shapes[0].dtype == "bf16"
        assert ops[0].replica_groups == [list(range(8))]

    def test_wait_tensor_is_not_recorded(self):
        from torch.distributed import _functional_collectives as fc
        t = torch.ones(4, dtype=torch.float32)
        ops = self._record(lambda: fc.wait_tensor(
            fc.all_reduce(t, "sum", dist.group.WORLD)))
        assert [op.kind for op in ops] == ["all-reduce"]
        assert ops[0].result_shapes[0].dtype == "f32"


def test_serve_entry_point_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.serve`` end to end at test scale."""
    mesh_4x2()
    path = tmp_path / "serve.json"
    toks = launch.main(["--reduced", "--device", "cpu", "--batch", "8",
                        "--prompt-len", "8", "--tokens", "3",
                        "--report", str(path)])
    assert tuple(toks.shape) == (8, 3)
    out = capsys.readouterr().out
    assert "per-phase collectives" in out and "[phase decode]" in out
    ref = ref_ser.report_from_dict(json.loads(path.read_text()))
    assert ref.phase_names() == ["prefill", "decode"]


def test_dtensor_alltoall_is_recorded():
    """On a non-CPU mesh DTensor's shard-to-shard redistribution calls its
    own ``_dtensor.shard_dim_alltoall`` op, which reaches no ``c10d`` op
    under ``FakeTensorMode``; the interceptor records it as an all-to-all."""
    import torch.distributed.tensor._collective_utils  # noqa: F401 (op)
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = mesh_4x2()
    group = mesh.get_group("data").group_name
    with FakeTensorMode(), CollectiveInterceptor(mesh) as icpt:
        out = torch.ops._dtensor.shard_dim_alltoall(
            torch.empty(2, 32, 64, dtype=torch.bfloat16), 0, 2, group)
    assert tuple(out.shape) == (8, 32, 16)
    [op] = icpt.ops
    assert op.kind == "all-to-all"
    assert op.result_shapes[0].dims == (8, 32, 16)
    assert op.replica_groups == [[0, 2, 4, 6], [1, 3, 5, 7]]


# ---------------------------------------------------------------------------
# RecurrentGemma (the hybrid family)
# ---------------------------------------------------------------------------
def test_a_second_capture_records_the_same_groups():
    """DTensor caches sharding decisions across meshes of equal layout, so
    a second ``launch.monitor`` in one process issues collectives on the
    first mesh's groups; the interceptor matches groups by their ranks and
    records the same profile both times."""
    first = _serve_report()
    again = launch.monitor(configs.config("qwen3_8b", reduced=True),
                           mesh_shape=(4, 2), batch=8, prompt_len=32,
                           tokens=24, device="cpu")
    assert _table(again) == _table(first) == PINNED
    assert [op.replica_groups for op in again.compiled_ops] == \
        [op.replica_groups for op in first.compiled_ops]
    assert all(len(op.replica_groups) in (2, 4) for op in again.compiled_ops)


def test_griffin_two_phase_profile_is_pinned():
    rep = _serve_report("recurrentgemma_2b")
    assert rep.phase_names() == ["prefill", "decode"]
    assert _table(rep) == PINNED_GRIFFIN
    assert all(op.weight == 1.0 for op in rep.compiled_ops)


def _rows(ops, weight=lambda op: 1.0):
    """(kind, mesh axis, per-device dims, dtype) -> weighted calls."""
    out: dict = {}
    for op in ops:
        groups = op.replica_groups
        axis = ("model" if groups == [[0, 1], [2, 3], [4, 5], [6, 7]]
                else "data" if groups == [[0, 2, 4, 6], [1, 3, 5, 7]]
                else "-")
        key = (op.kind, axis, op.result_shapes[0].dims,
               op.result_shapes[0].dtype)
        out[key] = out.get(key, 0) + weight(op)
    return out


def test_griffin_decode_against_gspmd():
    """The port's capture of the reduced RecurrentGemma decode step against
    the reference's GSPMD capture of the same step (``monitor_fn`` over
    ``decode_step`` as ``repro.launch.serve`` runs it, batch 8, cache 56,
    4x2 mesh).  Where they differ, the difference is pinned:

    * GSPMD scans the two superblocks, so each of its ops has weight 2; the
      port unrolls them (weight 1);
    * both all-reduce the row-parallel outputs over ``model``;
    * the dense RG-LRU gate products, the reference's only fp32 collectives:
      GSPMD all-gathers the ``rnn``-sharded conv output over ``model``,
      fuses the ``w_a`` and ``w_x`` products into one and realigns its
      split halves with collective-permutes; DTensor multiplies the shards
      by the row-sharded ``w_a`` and ``w_x`` and reduce-scatters each fp32
      partial product over ``model``, two per recurrent layer;
    * DTensor turns data-partial products into batch-sharded rows with
      reduce-scatters (the Qwen profile's difference, above);
    * the port decodes each attention layer's sequence shard of the ring
      (``kv_seq``, 16 of its 32 slots) and merges the partials with two
      fp32 all-reduces over ``model``, a max of the (2, 4) log-sum-exp and
      a sum of the packed (2, 4, 17) output; GSPMD's partitioned decode
      issues none of its own here;
    * the RG-LRU scan itself issues no collective in either: it is
      elementwise over the ``rnn`` shards
      (:func:`test_rglru_scan_on_rnn_shards_issues_no_collective`).
    """
    from repro.configs import config as ref_config
    from repro.core import monitor_fn as ref_monitor_fn
    from repro.launch.mesh import make_test_mesh
    from repro.models import build_model as ref_build_model
    from repro.parallel import Sharder as RefSharder
    import jax
    import jax.numpy as jnp

    mesh = make_test_mesh((4, 2), ("data", "model"))
    shd = RefSharder(mesh)
    model = ref_build_model(ref_config("recurrentgemma_2b", reduced=True))
    ref = ref_monitor_fn(
        lambda p, c, b: model.decode_step(p, c, b, shd), model.shapes(),
        model.cache_shapes(8, 56),
        {"tokens": jax.ShapeDtypeStruct((8, 1), jnp.int32)}, mesh=mesh,
        name="decode[recurrentgemma_2b]")
    port = _serve_report("recurrentgemma_2b")
    port_decode = [op for op in port.compiled_ops if op.phase == "decode"]

    assert {k: v["calls"] for k, v in ref.compiled_summary.items()} == {
        "all-gather": 4, "all-reduce": 12, "collective-permute": 12}
    assert {op.weight for op in ref.compiled_ops} == {2.0}
    assert {kind for _, kind in PINNED_GRIFFIN} == {
        "all-gather", "all-reduce", "reduce-scatter"}

    ref_rows = _rows(ref.compiled_ops, weight=lambda op: op.weight)
    port_rows = _rows(port_decode)
    # row-parallel outputs: batch-sharded rows (8 / 4 = 2) of d_model 64
    assert ref_rows[("all-reduce", "model", (2, 1, 64), "bf16")] == 12
    assert port_rows[("all-reduce", "model", (2, 1, 64), "bf16")] == 8
    # the fp32 collectives: the RG-LRU gate products in both, the port's
    # log-sum-exp merge
    assert {k: v for k, v in ref_rows.items() if k[3] == "f32"} == {
        ("all-gather", "model", (2, 1, 64), "f32"): 4,
        ("collective-permute", "-", (2, 1, 128), "f32"): 12}
    assert {k: v for k, v in port_rows.items() if k[3] == "f32"} == {
        ("reduce-scatter", "model", (2, 1, 32), "f32"): 8,
        ("all-reduce", "model", (2, 4), "f32"): 2,
        ("all-reduce", "model", (2, 4, 17), "f32"): 2}


def test_rglru_scan_on_rnn_shards_issues_no_collective():
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.parallel import Sharder

    mesh = mesh_4x2()
    shd = Sharder(mesh)
    sess = MonitorSession(mesh=mesh, name="rglru")
    with sess.fake_mode:
        x = torch.empty(8, 16, 64)
        h0 = torch.empty(8, 64)

    def fn(x, la, h0):
        x = distribute_tensor(x, mesh, (Shard(0), Shard(2)),
                              src_data_rank=None)
        la = distribute_tensor(la, mesh, (Shard(0), Shard(2)),
                               src_data_rank=None)
        h0 = distribute_tensor(h0, mesh, (Shard(0), Shard(1)),
                               src_data_rank=None)
        ax = ("batch", "seq", "rnn")
        return shd.local(rg_ops.rglru_scan, (x, la, h0),
                         (ax, ax, ("batch", "rnn")))

    cap = sess.capture(fn, x, x, h0)
    assert cap.ops == []


def test_serve_entry_point_recurrentgemma_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.serve --arch recurrentgemma_2b`` end
    to end at test scale: prompt 30 + 4 tokens wraps the 32-slot ring."""
    mesh_4x2()
    path = tmp_path / "serve.json"
    toks = launch.main(["--arch", "recurrentgemma_2b", "--reduced",
                        "--device", "cpu", "--batch", "8", "--prompt-len",
                        "30", "--tokens", "4", "--report", str(path)])
    assert tuple(toks.shape) == (8, 4)
    out = capsys.readouterr().out
    assert "recurrentgemma-2b-reduced 6L on cpu" in out
    assert "per-phase collectives" in out and "[phase decode]" in out
    ref = ref_ser.report_from_dict(json.loads(path.read_text()))
    assert ref.phase_names() == ["prefill", "decode"]
