"""The lint over the port's own full-width captures, pinned.

``chip_smoke.py`` lints every capture of its monitor phase on the card (on
``cuda`` meshes) and holds the findings, rule -> count, to its
``LINT_COUNTS``.  Here the same programs are captured on the CPU, where one
thing differs by design: a CPU mesh has no all-to-all, so DTensor
redistributes shard to shard with an all-gather and keeps one chunk of it
(the "falling back with allgather + chunk" log line), which is exactly an
``allgather-then-slice``.  So the CPU table is the card's plus one finding
for each all-to-all the card's capture records (``MONITOR_CALLS``), and
those extra findings are each an all-gather consumed by one ``chunk`` or
``split``.  On both, each attention layer of a serve decode flags one
``small-ar-bucketing``: the two small all-reduces over ``model`` that merge
the sequence-sharded cache's partials (a max, then a sum) run back to
back.

Against the reference, one difference is pinned: GNMT's startup Broadcast
gathers every rank's copy of a parameter and keeps rank 0's.  The port
flags each such all-gather; the reference's HLO has XLA fuse the slice into
a ``slice_bitcast_fusion``, whose ``fusion`` opcode its rule does not read
as a slice, so it flags none.
"""
import importlib.util
import warnings
from collections import Counter
from pathlib import Path

import pytest

from repro import sweep as ref_sweep
from repro.core import lint as ref_lint
from repro_torch import sweep
from repro_torch.launch import paper as paper_launch
from repro_torch.launch import serve as serve_launch
from torch_fixtures import mesh_4x2

ROOT = Path(__file__).resolve().parents[1]
# the CPU captures' findings, rule -> count
LINT_CPU = {
    "qwen3_8b": {"allgather-then-slice": 508, "small-ar-bucketing": 36},
    "recurrentgemma_2b": {"allgather-then-slice": 264,
                          "small-ar-bucketing": 8},
    "resnet": {},
    "gnmt": {"allgather-then-slice": 16},
    "paper": {},
}
SERVE = ("qwen3_8b", "recurrentgemma_2b")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REPORTS: dict = {}


def _report(name):
    """The capture ``chip_smoke.py`` lints, on a CPU mesh."""
    if name not in _REPORTS:
        mesh_4x2()
        cs = _chip_smoke()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if name in SERVE:
                _REPORTS[name] = serve_launch.monitor(
                    serve_launch.model_config(name), mesh_shape=(4, 2),
                    batch=cs.BATCH, prompt_len=cs.PROMPT_LEN,
                    tokens=cs.NEW_TOKENS, device="cpu")
            else:
                _REPORTS[name] = paper_launch.monitor(
                    paper_launch.make_app(name), mesh_spec="8",
                    device="cpu")
    return _REPORTS[name]


def _counts(findings):
    return dict(Counter(f.rule_id for f in findings))


@pytest.mark.parametrize("name", sorted(LINT_CPU))
def test_full_width_capture_findings_pinned(name):
    rep = _report(name)
    findings = rep.lint()
    assert _counts(findings) == LINT_CPU[name]
    for f in findings:
        assert 0.0 <= f.est_savings_s <= f.est_current_s
    assert rep.lint_table().startswith(f"== {rep.name}: lint findings ==")


@pytest.mark.parametrize("name", sorted(LINT_CPU))
def test_cpu_table_is_the_cards_plus_the_alltoall_fallback(name):
    cs = _chip_smoke()
    want = Counter(cs.LINT_COUNTS[name])
    if name in SERVE:
        want["allgather-then-slice"] += sum(
            n for (_ph, kind), n in cs.MONITOR_CALLS[name].items()
            if kind == "all-to-all")
    assert _counts(_report(name).lint()) == dict(+want)


@pytest.mark.parametrize("name", SERVE)
def test_fallback_gathers_are_consumed_by_one_chunk(name):
    rep = _report(name)
    flagged = {(f.phase, n) for f in rep.lint()
               if f.rule_id == "allgather-then-slice" for n in f.op_names}
    seen = 0
    for graph in rep._defuse_graphs:
        for node in graph.collective_nodes:
            op = graph.ops_by_name[node.collective]
            if (op.phase, op.name) in flagged:
                assert op.kind == "all-gather"
                users = graph.effective_users(node.name)
                assert [opc for _, opc in users] in (["chunk"], ["split"])
                seen += 1
    assert seen == len(flagged) == LINT_CPU[name]["allgather-then-slice"]


def test_gnmt_broadcast_difference_is_xlas_slice_fusion():
    ref_mesh = ref_sweep.build_mesh("8")
    ref = ref_sweep._monitor_cell(
        ref_sweep.available_configs()["gnmt"].build(ref_mesh), ref_mesh,
        "gnmt", "ring")
    assert _counts(ref.lint()) == {}
    consumers = []
    for text in ref._all_hlo_texts():
        mod = ref_lint._ModuleIndex(text)
        for comp, colls in mod.collectives.items():
            for c in colls:
                if c.kind == "all-gather":
                    consumers.append(mod.effective_users(comp, c.name))
    fused = [u for u in consumers if u is not None]
    assert len(fused) == 16 and all(
        opc == "fusion" and name.startswith("slice_bitcast_fusion")
        for users in fused for name, opc in users)
    port = sweep._monitor_cell(sweep.available_configs()["gnmt"].build,
                               sweep.build_mesh("8", device="cpu"), "gnmt")
    assert _counts(port.lint()) == {"allgather-then-slice": 16}
