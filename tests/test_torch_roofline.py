"""The port's op counts (``repro_torch.core.op_cost``) and roofline
(``repro_torch.core.roofline``, ``roofline_of``) against the reference's
``hlo_cost``/``roofline`` on the CPU.

FLOPs: the paper's three applications and the ``serve`` cell are captured
by both packages on a 4x2 mesh; the port's counted per-device FLOPs equal
the reference's ``analyze_hlo`` FLOPs of the compiled modules, except where
a test below pins the difference and says why.  Each kernel op's formula is
held against ``analyze_hlo`` of the reference's XLA path for the same call.

Bytes cannot match (XLA's fusion-boundary traffic against eager per-op
traffic): the port's rule is pinned on a hand-built program instead.

The collective terms are the same functions on the same ops in both
packages: on the committed serve fixture's ops they are equal exactly.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sweep as ref_sweep
from repro.core import hlo_cost as ref_hlo_cost
from repro.core import roofline as ref_roofline
from repro.core.export import serialize as ref_ser
from repro.core.monitor import roofline_of as ref_roofline_of
from repro.models.attention import chunked_attention, decode_attention
from repro_torch import configs, sweep
from repro_torch.core import CommReport, MonitorSession, roofline, roofline_of
from repro_torch.core.export import serialize as ser
from repro_torch.core.op_cost import (OpCostMode, flash_attention_flop,
                                      flash_decode_flop)
from repro_torch.kernels.flash_attention.ops import attend
from repro_torch.kernels.flash_decode.ops import decode_attend
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.launch import serve as launch
from repro_torch.parallel import Sharder
from torch_fixtures import mesh_4x2

FIXTURES = Path(__file__).parent / "fixtures"

_CELLS: dict = {}


def _cells(name: str):
    """(port report, reference report) of one sweep config on 4x2."""
    if name not in _CELLS:
        mesh_4x2()
        mesh = sweep.build_mesh("4x2", device="cpu")
        port = sweep._monitor_cell(sweep.available_configs()[name].build,
                                   mesh, name)
        rmesh = ref_sweep.build_mesh("4x2")
        ref = ref_sweep._monitor_cell(
            ref_sweep.available_configs()[name].build(rmesh), rmesh, name,
            "ring")
        _CELLS[name] = port, ref
    return _CELLS[name]


def _ref_flops(ref) -> float:
    return sum(ref_hlo_cost.analyze_hlo(t).flops for t in ref._hlo_texts)


# ---------------------------------------------------------------------------
# FLOPs of whole cells
# ---------------------------------------------------------------------------
# reference FLOPs - port FLOPs per device, and why:
#   resnet: XLA computes the input gradient of a stride-2 convolution as a
#     convolution over the input dilated by the stride (zeros inserted), so
#     its HLO count is stride^2 = 4 times the forward's; eager cuDNN/CPU
#     ``convolution_backward`` is counted like the forward.  The six
#     stride-2 convolutions (three 3x3, three 1x1 shortcuts; forward 75.5 M
#     and 8.4 M FLOPs each at 2 images of 32^2) give 3 x 3 x (75497472 +
#     8388608).
#   gnmt: the reference's scanned decoder body differentiates its first
#     attention score against the carried top state on every trip, the
#     zero initial state included; eager autograd computes no gradient for
#     the zero initial state (it does not require grad), one (2,16)x(16,64)
#     product, 2*2*16*64 FLOPs, a train step, 4 steps.  (The two programs
#     also split the LSTM input projections differently -- one matmul over
#     all steps against one a step -- which moves no FLOPs.)
FLOP_GAP = {
    "paper": 0,
    "resnet": 3 * 3 * (75497472 + 8388608),
    "gnmt": 4 * 2 * 2 * 16 * 64,
}


@pytest.mark.parametrize("name", sorted(FLOP_GAP))
def test_paper_app_flops_equal_reference_hlo(name):
    port, ref = _cells(name)
    assert port.cost["flops"] == _ref_flops(ref) - FLOP_GAP[name]
    assert port.cost["flops"] > 0


def test_serve_cell_flops_equal_reference_hlo():
    """The serve cell at the reference's sizes: DTensor's plan moves other
    bytes than GSPMD's (ROADMAP queue 3 item 6) but, counted on each
    device's local shards, does the same work: 18,530,304 FLOPs per device
    on both sides, and the attention kernels' formulas equal the
    reference's attention dots (full score blocks over the 32-token prompt,
    decode over the whole 48-slot cache) exactly.  A count that took
    DTensor's global-shape sharding propagation for work would be 2.6x
    this."""
    port, ref = _cells("serve")
    assert port.cost["flops"] == _ref_flops(ref) == 18530304.0
    ref_attention = 0.0
    for text in ref._hlo_texts:
        for val, _, opcode, _, line in ref_hlo_cost.top_ops(
                text, n=10 ** 6, by="flops"):
            if opcode == "dot" and line.split("=")[1].split("{")[0].count(
                    ",") >= 2:            # the rank-3 and rank-4 dots
                ref_attention += val
    cfg = configs.config("qwen3_8b", reduced=True)
    heads = cfg.n_heads // 2                 # model-sharded heads
    port_attention = cfg.n_layers * (
        flash_attention_flop((2, 32, heads, cfg.head_dim),
                             (2, 32, heads, cfg.head_dim), None)
        + flash_decode_flop((2, heads, cfg.head_dim),
                            (2, 48, heads, cfg.head_dim), None))
    assert port_attention == ref_attention == 1097728


def test_capture_count_does_not_depend_on_history():
    """DTensor caches its sharding propagation, so a count that included
    the propagator's fake runs would fall on a second capture; it does
    not."""
    first, _ = _cells("serve")
    again = sweep._monitor_cell(sweep.available_configs()["serve"].build,
                                sweep.build_mesh("4x2", device="cpu"),
                                "serve")
    assert again.cost == first.cost


def test_capture_cost_sums_over_captures():
    port, _ = _cells("serve")
    mesh = mesh_4x2()
    sess = MonitorSession(mesh=mesh, name="twice")
    with sess.fake_mode:
        a = torch.empty(16, 32)
        b = torch.empty(32, 8)
    for _ in range(2):
        sess.capture(lambda x, y: x @ y, a, b)
    one = sess.captures[0].cost
    assert one == {"flops": 2 * 16 * 32 * 8,
                   "bytes accessed": 4 * (16 * 32 + 32 * 8 + 16 * 8)}
    assert sess.report().cost == {k: 2 * v for k, v in one.items()}
    assert set(port.cost) == {"flops", "bytes accessed"}


# ---------------------------------------------------------------------------
# the four kernel ops: formula == the reference's HLO count of its XLA path
# ---------------------------------------------------------------------------
def _hlo_flops(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return ref_hlo_cost.analyze_hlo(
        jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("b,sq,skv,h,kvh,dh,window", [
    (2, 64, 64, 4, 2, 16, 0),        # one query chunk, GQA
    (1, 1024, 1024, 2, 1, 8, 0),     # two chunks, full keys each
    (1, 1024, 1024, 2, 2, 8, 256),   # two chunks, window + 512 keys each
    (1, 1024, 640, 2, 2, 8, 256),    # the window does not cut 640 keys
])
def test_flash_attention_formula_matches_chunked_attention(b, sq, skv, h,
                                                           kvh, dh, window):
    want = _hlo_flops(
        lambda q, k, v: chunked_attention(q, k, v, causal=True,
                                          window=window),
        (b, sq, h, dh), (b, skv, kvh, dh), (b, skv, kvh, dh))
    q = torch.randn(b, sq, h, dh)
    k = torch.randn(b, skv, kvh, dh)
    with OpCostMode() as mode:
        attend(q, k, k, causal=True, window=window)
    assert mode.cost()["flops"] == want > 0


@pytest.mark.parametrize("b,L,h,kvh,dh,window", [
    (2, 48, 4, 2, 16, 0), (3, 160, 8, 1, 32, 64)])
def test_flash_decode_formula_matches_decode_attention(b, L, h, kvh, dh,
                                                       window):
    want = _hlo_flops(
        lambda q, k, v: decode_attention(q, k, v, jnp.int32(L // 2),
                                         window=window),
        (b, 1, h, dh), (b, L, kvh, dh), (b, L, kvh, dh))
    k = torch.randn(b, L, kvh, dh)
    with OpCostMode() as mode:
        decode_attend(torch.randn(b, h, dh), k, k,
                      torch.tensor(L // 2, dtype=torch.int32), window=window)
    assert mode.cost()["flops"] == want > 0


def test_rmsnorm_and_rglru_count_no_flops_as_in_hlo():
    from repro.kernels.rglru.ops import rglru_scan as ref_rglru
    from repro.models.common import rms_norm as ref_rms_norm

    assert _hlo_flops(lambda x, w: ref_rms_norm(x, w),
                      (4, 8, 64), (64,)) == 0
    assert _hlo_flops(lambda x, a: ref_rglru(x, a), (2, 16, 32),
                      (2, 16, 32)) == 0
    with OpCostMode() as mode:
        rmsnorm(torch.randn(4, 8, 64), torch.randn(64))
        rglru_scan(torch.randn(2, 16, 32), -torch.rand(2, 16, 32))
    assert mode.cost()["flops"] == 0
    assert mode.cost()["bytes accessed"] > 0


# ---------------------------------------------------------------------------
# bytes: each op's inputs plus outputs, views free, one device's shapes
# ---------------------------------------------------------------------------
def test_bytes_rule_on_a_hand_built_program():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    m, k, n = 64, 32, 16
    a, b = torch.randn(m, k), torch.randn(k, n)
    with OpCostMode() as mode:
        c = a @ b                    # mm: read a, b; write c
        d = c * c.t().t()            # two views (free), one mul: 2 reads
    assert torch.equal(d, c * c)
    assert mode.cost() == {"flops": 2.0 * m * k * n,
                           "bytes accessed": 4.0 * (m * k + k * n + m * n
                                                    + 3 * m * n)}
    mesh = mesh_4x2()                # rows of a over data, b replicated
    da = DTensor.from_local(torch.randn(m // 4, k), mesh,
                            [Shard(0), Replicate()])
    db = DTensor.from_local(b, mesh, [Replicate(), Replicate()])
    with OpCostMode() as mode:
        dc = da @ db
    assert dc.to_local().shape == (m // 4, n)
    assert mode.cost() == {"flops": 2.0 * (m // 4) * k * n,
                           "bytes accessed": 4.0 * ((m // 4) * k + k * n
                                                    + (m // 4) * n)}


def test_prefill_counts_equal_live_and_fake():
    """The counter sees each kernel op as one op, plain version or kernel,
    real or fake tensors: the CPU analogue of the card's check.  Under
    ``inference_mode`` (how the server runs) composite ops reach the mode
    undecomposed; the count must still be grad mode's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    cfg = configs.config("qwen3_8b", reduced=True)
    res = launch.serve(cfg, batch=2, prompt_len=8, tokens=2, device="cpu")
    model, batch = res["model"], {"tokens": res["prompts"]}
    with torch.inference_mode(), OpCostMode() as live:
        model.prefill(res["params"], batch, Sharder(), max_len=10)
    with torch.no_grad(), OpCostMode() as graded:
        model.prefill(res["params"], batch, Sharder(), max_len=10)
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fp, fb = tree_map(fm.from_tensor, (res["params"], batch))
        with torch.inference_mode(), OpCostMode() as fake:
            model.prefill(fp, fb, Sharder(), max_len=10)
    assert live.cost() == fake.cost() == graded.cost()
    attention = cfg.n_layers * flash_attention_flop(
        (2, 8, cfg.n_heads, cfg.head_dim),
        (2, 8, cfg.n_kv_heads, cfg.head_dim), None)
    # the projections, the MLP and the last-token head count too
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.n_heads * cfg.head_dim + 2 * cfg.n_kv_heads * cfg.head_dim
    dense = 2 * 2 * 8 * cfg.n_layers * (d * hd + cfg.n_heads * cfg.head_dim
                                        * d + 3 * d * f) + 2 * 2 * d * v
    assert live.cost()["flops"] == attention + dense


# ---------------------------------------------------------------------------
# the roofline: collective terms exact, the report's fields
# ---------------------------------------------------------------------------
COST = {"flops": 3.0e11, "bytes accessed": 7.0e9}


def _fixture_pair():
    d = json.loads((FIXTURES / "serve_report.json").read_text())
    d["cost"] = dict(COST)
    return ser.report_from_dict(d), ref_ser.report_from_dict(d)


@pytest.mark.parametrize("algorithm", ["ring", "tree", "hierarchical"])
def test_collective_terms_equal_reference_exactly(algorithm, monkeypatch):
    port, ref = _fixture_pair()
    got = roofline_of(port, mesh_name="4x2", algorithm=algorithm,
                      model_flops=1e12)
    # the reference's analyze, with its HLO walk replaced by the same ops
    # and the same counted cost
    monkeypatch.setattr(ref_hlo_cost, "analyze_hlo", lambda text: (
        ref_hlo_cost.HloCost(flops=COST["flops"], bytes_logical=0.0,
                             bytes_hbm=COST["bytes accessed"],
                             collectives=list(ref.compiled_ops))))
    want = ref_roofline.analyze(
        arch=ref.name, mesh_name="4x2", cost=ref.cost, hlo_text="",
        topo=ref.topo, hw=ref.topo.hw, model_flops=1e12,
        memory_stats=ref.memory_stats, algorithm=algorithm,
        link_utilization=ref.link_utilization(algorithm))
    assert roofline.to_row(got) == ref_roofline.to_row(want)
    assert got.collective_breakdown == want.collective_breakdown
    assert (got.bound_time_s, got.peak_fraction, got.one_liner()) == (
        want.bound_time_s, want.peak_fraction, want.one_liner())
    assert got.collective_overlap_s <= got.collective_s_topo
    assert got.memory_bytes_per_device["cost_analysis_flops"] == COST["flops"]


def test_model_flops_helpers_and_row_keys():
    assert roofline.train_model_flops(7e9, 1024) == \
        ref_roofline.train_model_flops(7e9, 1024)
    assert roofline.forward_model_flops(7e9, 1024) == \
        ref_roofline.forward_model_flops(7e9, 1024)
    assert [f.name for f in dataclasses.fields(roofline.RooflineReport)] \
        == [f.name for f in dataclasses.fields(ref_roofline.RooflineReport)]


def test_roofline_of_a_capture():
    port, _ = _cells("paper")
    r = roofline_of(port, mesh_name="4x2")
    assert r.flops_per_device == port.cost["flops"]
    assert r.bytes_per_device == port.cost["bytes accessed"]
    assert r.compute_s == port.cost["flops"] / port.topo.hw.peak_flops_bf16
    assert r.wire_bytes_per_device == port.total_wire_bytes() / 8
    assert r.dominant in ("compute", "memory", "collective")


# ---------------------------------------------------------------------------
# cross-loading: the cost section both ways, and what each roofline refuses
# ---------------------------------------------------------------------------
def test_counted_cost_cross_loads(tmp_path):
    port, _ = _cells("paper")
    path = tmp_path / "port.json"
    port.save(str(path))
    ref = ref_ser.report_from_dict(json.loads(path.read_text()))
    assert ref.cost == port.cost
    back = ser.report_from_dict(ref_ser.report_to_dict(ref))
    assert back.cost == port.cost
    assert roofline.to_row(roofline_of(back)) == \
        roofline.to_row(roofline_of(port))
    # the reference's roofline walks HLO, which a port file never has
    with pytest.raises(ValueError, match="no compiled HLO"):
        ref_roofline_of(ref)


def test_roofline_of_refuses_reports_without_counted_cost():
    d = json.loads((FIXTURES / "serve_report.json").read_text())
    xla = ser.report_from_dict(d)            # XLA's cost_analysis
    assert "flops" in xla.cost and "transcendentals" in xla.cost
    with pytest.raises(ValueError, match="no counted cost"):
        roofline_of(xla)
    d["cost"] = {}
    with pytest.raises(ValueError, match="no counted cost"):
        roofline_of(ser.report_from_dict(d))
    d["topo"] = None
    with pytest.raises(ValueError, match="no topology"):
        roofline_of(ser.report_from_dict(d))
    assert isinstance(xla, CommReport) and np.isfinite(xla.total_wire_bytes())
