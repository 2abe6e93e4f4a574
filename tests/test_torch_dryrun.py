"""The production-mesh dry run (``repro_torch.launch.{mesh,dryrun}``, ``python
-m repro_torch dryrun``) against the reference's ``repro.launch.dryrun``.

The fake process group is process-global and takes one world size, so the
256- and 512-rank meshes are driven in subprocesses (``--device cpu``),
each patching ``repro_torch.configs.config`` to the ``REDUCED`` configs:
the same families at test scale, captured at the production shapes
(batch 128 x 32768-slot caches, 32 x 32768-token prefills, a 524288-slot
long decode).  The per-kind tables are pinned on the 4x2 mesh of the
other port tests beside the reference's ``lower_cell(...).compile()``
parsed by its ``hlo_parser``, the reference's config swapped for its
``REDUCED`` by ``monkeypatch`` (its files stay as they are).
"""
import inspect
import json
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

from repro.launch import dryrun as ref_dryrun
from repro.launch.mesh import mesh_name as ref_mesh_name
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import mesh_name
from repro_torch.models.common import SHAPES_BY_NAME
from torch_fixtures import mesh_4x2

ROOT = Path(__file__).resolve().parents[1]
# the child's preamble: REDUCED configs, and (for ``--mesh both``) the
# production meshes' shapes cut as the test asks
PREAMBLE = """
import sys
sys.path.insert(0, {src!r})
import repro_torch.configs as c
from repro_torch.launch import dryrun, mesh
_config = c.config
c.config = lambda arch, reduced=False: _config(arch, reduced=True)
mesh.SINGLE_POD, mesh.MULTI_POD = {single!r}, {multi!r}
"""


def _child(body: str, single=(16, 16), multi=(2, 16, 16)) -> str:
    return PREAMBLE.format(src=str(ROOT / "src"), single=single,
                           multi=multi) + textwrap.dedent(body)


def _run(code: str, timeout: int = 240) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def _ref_result_keys() -> list:
    """The keys of the reference's ``run_cell`` result, read from its
    source (it lowers on 512 host devices, which a test process has not)."""
    src = inspect.getsource(ref_dryrun.run_cell)
    start = src.index("result = {")
    body = src[start:src.index("\n    }\n", start)]
    return re.findall(r'"(\w+)":', body)


def test_mesh_name_is_the_references():
    """``mesh_name`` of the port's meshes equals the reference's string
    for the same shape and axes."""
    assert mesh_name(mesh_4x2()) == "4x2:data,model"
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        port = types.SimpleNamespace(shape=shape, mesh_dim_names=axes)
        ref = types.SimpleNamespace(devices=np.empty(shape),
                                    axis_names=axes)
        assert mesh_name(port) == ref_mesh_name(ref)
    assert mesh_name(types.SimpleNamespace(
        shape=(16, 16), mesh_dim_names=("data", "model"))) == \
        "16x16:data,model"


# the reduced cells each child runs for ``--all`` (``configs.cells``
# patched): both families' decode_32k and prefill_32k, RecurrentGemma-2B's
# long_500k
CELLS = (("qwen3_8b", "decode_32k"), ("qwen3_8b", "prefill_32k"),
         ("recurrentgemma_2b", "decode_32k"),
         ("recurrentgemma_2b", "prefill_32k"),
         ("recurrentgemma_2b", "long_500k"))


def test_production_meshes_in_children(tmp_path):
    """``dryrun.main(["--all", "--mesh", "both", ...])`` on CPU meshes, the
    reduced configs: the parent runs one child a mesh, 16x16 and 2x16x16,
    and is left without a process group; each cell writes one JSON with
    the reference's keys, ok, on its production mesh, and its decode
    cache's bytes per device (the step's ``alias_bytes``, the cache it
    updates in place) equal :func:`dryrun.cache_bytes_per_device`."""
    child = _child(f"""
        c.cells = lambda include_long=True: {list(CELLS)!r}
        sys.exit(dryrun.main(sys.argv[1:]))
        """)
    args = ["--all", "--mesh", "both", "--device", "cpu", "--out",
            str(tmp_path)]
    parent = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT / 'src')!r})
        import torch.distributed as dist
        from repro_torch.launch import dryrun
        dryrun.CHILD = [sys.executable, "-c", {child!r}]
        rc = dryrun.main({args!r})
        print("process group:", dist.is_initialized())
        sys.exit(rc)
        """)
    proc = _run(parent)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "process group: False" in proc.stdout
    assert proc.stdout.count("  ok: mem/dev=") == 2 * len(CELLS)
    keys = _ref_result_keys()
    assert keys == ["arch", "shape", "mesh", "devices", "ok", "trace_s",
                    "compile_s", "memory", "cost", "collectives",
                    "roofline", "tag"]
    for mname, devices, shape, axes in (
            ("single", 256, (16, 16), ("data", "model")),
            ("multi", 512, (2, 16, 16), ("pod", "data", "model"))):
        for arch, sname in CELLS:
            r = json.loads((tmp_path / f"{arch}_{sname}_{mname}.json")
                           .read_text())
            assert list(r) == keys
            assert r["ok"] and r["devices"] == devices
            assert r["mesh"] == mname and r["tag"] == ""
            assert r["compile_s"] == 0.0 and r["trace_s"] > 0
            mem = r["memory"]
            assert list(mem) == ["argument_bytes", "output_bytes",
                                 "temp_bytes", "alias_bytes", "total_bytes"]
            assert mem["total_bytes"] == (mem["argument_bytes"]
                                          + mem["output_bytes"]
                                          + mem["temp_bytes"]
                                          - mem["alias_bytes"])
            assert r["cost"]["flops"] > 0 and r["collectives"]
            assert r["roofline"]["devices"] == devices
            if SHAPES_BY_NAME[sname].kind == "decode":
                cfg = configs.config(arch, reduced=True)
                assert mem["alias_bytes"] == dryrun.cache_bytes_per_device(
                    cfg, SHAPES_BY_NAME[sname], shape, axes)
            else:
                assert mem["alias_bytes"] == 0


# the reduced xLSTM's cells: (shapes, --mesh) of each dryrun call
XLSTM_RUNS = ((("decode_32k", "long_500k"), "both"),
              (("prefill_32k", "train_4k"), "single"))


def test_xlstm_cells_in_children(tmp_path):
    """The reduced xLSTM's decode_32k and long_500k cells on both
    production meshes (``--mesh both``: one child a mesh), prefill_32k and
    train_4k on 16x16: every cell ok; a decode cell's bytes updated in
    place are its recurrent states, O(1) in the 32768 or 524288 slots,
    equal to :func:`dryrun.cache_bytes_per_device`.  The mLSTM parallel
    form and the sLSTM loop run as one op each, so the prefill_32k cell
    (2048 query chunks of the reduced 16 a layer) traces in seconds, where
    the same loop run op by op records about 50 ops a chunk and traced
    for minutes."""
    child = _child("sys.exit(dryrun.main(sys.argv[1:]))")
    calls = [["--arch", "xlstm_1_3b", "--shape", ",".join(shapes), "--mesh",
              mesh, "--device", "cpu", "--out", str(tmp_path)]
             for shapes, mesh in XLSTM_RUNS]
    # the parent runs the single-mesh call itself: the reduced configs too
    parent = _child(f"""
        dryrun.CHILD = [sys.executable, "-c", {child!r}]
        sys.exit(max(dryrun.main(args) for args in {calls!r}))
        """)
    proc = _run(parent)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    cfg = configs.config("xlstm_1_3b", reduced=True)
    meshes = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}
    for shapes, mesh in XLSTM_RUNS:
        for mname in (("single", "multi") if mesh == "both" else (mesh,)):
            shape, axes = meshes[mname]
            for sname in shapes:
                r = json.loads((tmp_path / f"xlstm_1_3b_{sname}_{mname}"
                                           ".json").read_text())
                assert r["ok"] and r["trace_s"] > 0, (sname, mname)
                mem = r["memory"]
                if SHAPES_BY_NAME[sname].kind == "decode":
                    want = dryrun.cache_bytes_per_device(
                        cfg, SHAPES_BY_NAME[sname], shape, axes)
                    assert mem["alias_bytes"] == want > 0, (sname, mname)
                elif sname == "prefill_32k":
                    assert mem["alias_bytes"] == 0
                    assert r["trace_s"] < 30, r["trace_s"]


def test_skip_existing_builds_no_mesh(tmp_path, capsys):
    """``--skip-existing`` skips a cell whose JSON is there before any
    mesh or capture."""
    (tmp_path / "qwen3_8b_decode_32k_multi_t.json").write_text("{}")
    assert dryrun.main(["--arch", "qwen3_8b", "--shape", "decode_32k",
                        "--mesh", "multi", "--tag", "t", "--skip-existing",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[skip] qwen3_8b_decode_32k_multi_t" in out
    assert "all dry-run cells passed" in out


# Full-size decode_32k (batch 128, 32768 slots, bf16 cache): one device's
# cache bytes, each row worked out by hand.  A transformer's cache is
# layers x (k, v) x batch / (batch shards) x slots / (model 16) x kv heads
# x head dim x 2 bytes, plus the 4-byte int32 length; the batch takes data
# 16 on one pod, pod x data 32 on two.  RecurrentGemma-2B holds a 2048-slot
# ring (its window) for each of its 8 attention layers, 1 kv head of 256,
# and two fp32 states a recurrent layer (8 superblocks' two and the tail's
# two: 18 of each; conv (3, 2560) and h (2560), ``rnn`` over model 16).
GB = 10 ** 9
CACHE_BYTES = [
    # Qwen3-8B: 36 x 2 x 128/16 x 32768/16 x 8 x 128 x 2 + 4
    ("qwen3_8b", (16, 16), 36 * 2 * 8 * 2048 * 8 * 128 * 2 + 4),
    # two pods: batch 128/32
    ("qwen3_8b", (2, 16, 16), 36 * 2 * 4 * 2048 * 8 * 128 * 2 + 4),
    # CodeQwen1.5-7B: 32 layers, MHA 32 kv heads of 128
    ("codeqwen15_7b", (16, 16), 32 * 2 * 8 * 2048 * 32 * 128 * 2 + 4),
    # Granite-3-2B: 40 layers, 8 kv heads of 64
    ("granite_3_2b", (16, 16), 40 * 2 * 8 * 2048 * 8 * 64 * 2 + 4),
    # Granite-20B: 52 layers, MQA, 1 kv head of 128
    ("granite_20b", (16, 16), 52 * 2 * 8 * 2048 * 1 * 128 * 2 + 4),
    # Chameleon-34B: 48 layers, 8 kv heads of 128
    ("chameleon_34b", (16, 16), 48 * 2 * 8 * 2048 * 8 * 128 * 2 + 4),
    # MusicGen-medium: 48 layers, MHA 24 kv heads of 64
    ("musicgen_medium", (16, 16), 48 * 2 * 8 * 2048 * 24 * 64 * 2 + 4),
    # RecurrentGemma-2B: 8 rings of 2048/16 slots, then the fp32 states:
    # 18 conv (8, 3, 2560/16) + 18 h (8, 2560/16), + 4
    ("recurrentgemma_2b", (16, 16), 8 * 2 * 8 * 128 * 1 * 256 * 2
     + 18 * 8 * 3 * 160 * 4 + 18 * 8 * 160 * 4 + 4),
    # xLSTM-1.3B: no slots, 24 superblocks' fp32 states, ``inner`` over
    # model 16: mLSTM C (8, 4, 1024/16, 1024), n (8, 4, 1024/16), m (8, 4),
    # conv (8, 3, 4096/16); sLSTM c, n, m, h (8, 2048/16); + 4
    ("xlstm_1_3b", (16, 16), 24 * (8 * 4 * 64 * 1024 * 4 + 8 * 4 * 64 * 4
                                   + 8 * 4 * 4 + 8 * 3 * 256 * 4
                                   + 4 * 8 * 128 * 4) + 4),
    # two pods: batch 128/32
    ("xlstm_1_3b", (2, 16, 16), 24 * (4 * 4 * 64 * 1024 * 4 + 4 * 4 * 64 * 4
                                      + 4 * 4 * 4 + 4 * 3 * 256 * 4
                                      + 4 * 4 * 128 * 4) + 4),
]


@pytest.mark.parametrize("arch,mesh_shape,want", CACHE_BYTES)
def test_full_size_decode_cache_bytes(arch, mesh_shape, want):
    axes = ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    got = dryrun.cache_bytes_per_device(configs.config(arch),
                                        SHAPES_BY_NAME["decode_32k"],
                                        mesh_shape, axes)
    assert got == want


def test_qwen_cache_is_2_42_gb_not_38_7():
    """Qwen3-8B's 619 GB decode_32k cache over 256 devices: 2.42 GB each
    with the sequence over model; the old kv-heads layout (8 heads do not
    divide model 16, so the cache was replicated over it) held 38.7 GB."""
    cfg = configs.config("qwen3_8b")
    shape = SHAPES_BY_NAME["decode_32k"]
    got = dryrun.cache_bytes_per_device(cfg, shape, (16, 16),
                                        ("data", "model"))
    assert round(got / GB, 2) == 2.42
    whole = 36 * 2 * 128 * 32768 * 8 * 128 * 2
    assert round(whole / GB) == 618
    heads_layout = whole // 16 + 4           # batch over data 16 only
    assert round(heads_layout / GB, 1) == 38.7


def test_failures_are_collected_and_exit_1(tmp_path):
    """A cell that fails is printed and counted, and the run exits 1."""
    body = """
        rc = dryrun.main(['--arch', 'qwen3_8b', '--shape', 'no_such_shape',
                          '--mesh', 'single', '--device', 'cpu',
                          '--out', {out!r}])
        sys.exit(rc)
        """.format(out=str(tmp_path))
    proc = _run(_child(body, single=(4, 2)))
    assert proc.returncode == 1
    assert "1 FAILURES:" in proc.stdout and "no_such_shape" in proc.stdout


def _kinds(summary):
    return {k: (r["calls"], r["payload_bytes"]) for k, r in summary.items()}


# kind -> (calls, payload bytes per device) of the reduced Qwen3-8B cells on
# the 4x2 mesh: the port's capture (a CPU mesh: all-gather and a chunk where
# a cuda mesh all-to-alls) and the reference's compiled HLO, its 4 layers
# scanned and counted once (every op of weight 1: the dry run's parser
# reads no trip count).  Decode: the port gathers q, k and v to all heads
# and merges the sequence shards' partials with two fp32 all-reduces a
# layer; GSPMD partitions the decode einsums over the sharded cache.
# Prefill: the port fills each layer's cache whole and reshards it to
# sequence shards.  Train (2 microbatches): the port's Python loop issues a
# microbatch's collectives once a microbatch, so at 1 microbatch it issues
# half the gathers and reduce-scatters; the reference scans the
# microbatches and its HLO holds the body once.
PORT_DRY = {
    "decode_32k": {"all-gather": (47, 1836032), "all-reduce": (17, 294912),
                   "reduce-scatter": (17, 917504)},
    "prefill_32k": {"all-gather": (38, 5369307136),
                    "all-reduce": (9, 1207959552),
                    "reduce-scatter": (1, 32768)},
    "train_4k": {"all-gather": (250, 17186029568),
                 "all-reduce": (137, 2961194104),
                 "reduce-scatter": (52, 3407872)},
}
REF_DRY = {
    "decode_32k": {"all-gather": (12, 494592), "all-reduce": (6, 69632),
                   "all-to-all": (1, 65536),
                   "collective-permute": (3, 32896)},
    "prefill_32k": {"all-gather": (10, 269221888),
                    "all-reduce": (2, 268435456),
                    "all-to-all": (2, 536870912),
                    "collective-permute": (3, 268451840)},
    "train_4k": {"all-gather": (20, 27525120), "all-reduce": (18, 546309472),
                 "all-to-all": (5, 2684354560),
                 "collective-permute": (13, 286785536)},
}
# the port's train_4k cell at 1 microbatch: the loop's collectives once
PORT_TRAIN_1 = {"all-gather": (125, 17182949376),
                "all-reduce": (71, 2961186392),
                "reduce-scatter": (26, 1703936)}
TRAIN = {"microbatches": 2}
# the same cells' ``memory`` (argument, output, temp, alias bytes a device):
# the port's eager order worked out from the fake tensors, the reference's
# XLA buffer assignment (``_memory_stats`` of the compiled cell).  Arguments
# and aliases agree to the byte; the outputs differ by the reference's 32
# bytes more.  Temp differs: the port's is the peak of live storage in
# issue order, XLA's a buffer assignment.  The port's decode and prefill
# peak inside one layer's MLP (its hidden resharded -- a CPU mesh
# all-gathers and chunks where a cuda mesh all-to-alls -- and concatenated,
# beside the up-projection's output and the gathered down-projection), the
# same at 2, 4 or 8 layers; the decode cache is written in place.
PORT_MEM = {
    "decode_32k": (537037700, 536887300, 135168, 536870916),
    "prefill_32k": (1215232, 134221828, 805302268, 0),
    "train_4k": (2597124, 499988, 13104289728, 499972),
}
REF_MEM = {
    "decode_32k": (537037700, 536887332, 1610797816, 536870916),
    "prefill_32k": (1215232, 134221860, 2382668616, 0),
    "train_4k": (2597124, 500352, 13317546776, 499972),
}
MEM_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")


@pytest.mark.parametrize("sname", sorted(PORT_DRY))
def test_reduced_cells_pinned_beside_reference(sname, monkeypatch):
    from repro import configs as ref_configs
    from repro.compat import make_mesh
    from repro.core import hlo_parser
    from repro_torch.core.summary import summarize

    over = TRAIN if sname == "train_4k" else None
    reduced = configs.config
    monkeypatch.setattr(configs, "config",
                        lambda a, reduced_=False: reduced(a, reduced=True))
    cell = dryrun.capture_cell("qwen3_8b", sname, mesh_4x2(),
                               train_overrides=over)
    assert _kinds(summarize(cell["ops"])) == PORT_DRY[sname]
    assert {op.weight for op in cell["ops"]} == {1.0}
    assert tuple(cell["memory"][k] for k in MEM_KEYS) == PORT_MEM[sname]

    ref_config = ref_configs.config
    monkeypatch.setattr(ref_configs, "config",
                        lambda a, reduced_=False: ref_config(a, reduced=True))
    lowered, _ = ref_dryrun.lower_cell(
        "qwen3_8b", sname, make_mesh((4, 2), ("data", "model")),
        train_overrides=over)
    compiled = lowered.compile()
    ops = hlo_parser.parse_hlo_collectives(compiled.as_text())
    assert _kinds(hlo_parser.summarize(ops)) == REF_DRY[sname]
    assert {op.weight for op in ops} == {1.0}
    ref_mem = ref_dryrun._memory_stats(compiled)
    assert tuple(ref_mem[k] for k in MEM_KEYS) == REF_MEM[sname]
    if sname == "train_4k":
        one = dryrun.capture_cell("qwen3_8b", sname, mesh_4x2(),
                                  train_overrides={"microbatches": 1})
        got = _kinds(summarize(one["ops"]))
        assert got == PORT_TRAIN_1
        for kind in ("all-gather", "reduce-scatter"):
            assert PORT_DRY[sname][kind][0] == 2 * got[kind][0]


# the same cells under ``--sp`` (``Sharder(mesh, enable_sp=True)``: seq over
# model) beside the reference's ``lower_cell(..., sp=True).compile()``.
# Prefill: the port gathers each weight whole for its products on the
# sequence shards (an all-gather over data, the FSDP one, and one over
# model a weight: the 12 + 12 + 4 + 4 small gathers), gathers k and v
# along the sequence a layer (4 + 4 of bf16[8,16384,4,16] a rank) and
# reshards each filled cache from kv heads to sequence shards (4 + 4, a
# CPU mesh's all-gather and chunk), gathers the ids over the sequence for
# the vocab-split table and scatters the lookup's partial sum back along
# it (the 32 MB reduce-scatter), where GSPMD keeps the ids split, reduces
# small partials and moves the last position by one 2 KB permute.  Train
# (2 microbatches): the same gathers a microbatch, twice more in the
# recomputed backward (``full`` remat), and each weight's gradient
# reduce-scattered back to its shards (the 120), where GSPMD moves
# activations by all-to-alls and permutes.  Decode: a one-token sequence
# does not split, so both packages capture exactly their non-SP tables.
PORT_DRY_SP = {
    "decode_32k": PORT_DRY["decode_32k"],
    "prefill_32k": {"all-gather": (68, 2153332736),
                    "reduce-scatter": (2, 134250496)},
    "train_4k": {"all-gather": (234, 2292711424),
                 "all-reduce": (78, 33960),
                 "reduce-scatter": (120, 1212022784)},
}
REF_DRY_SP = {
    "decode_32k": REF_DRY["decode_32k"],
    "prefill_32k": {"all-gather": (16, 270172160),
                    "all-reduce": (5, 2625664),
                    "collective-permute": (1, 2048)},
    "train_4k": {"all-gather": (41, 700121088), "all-reduce": (24, 40242048),
                 "all-to-all": (3, 272629760),
                 "collective-permute": (10, 50593792)},
}
# their memory: arguments (the batch split over the sequence too) and
# aliases agree to the byte; outputs by the reference's 32 bytes more
PORT_MEM_SP = {
    "decode_32k": PORT_MEM["decode_32k"],
    "prefill_32k": (690944, 134221828, 335540220, 0),
    "train_4k": (1548548, 499988, 13087206336, 499972),
}
REF_MEM_SP = {
    "decode_32k": REF_MEM["decode_32k"],
    "prefill_32k": (690944, 134221860, 2357543832, 0),
    "train_4k": (1548548, 500352, 13220373456, 499972),
}


@pytest.mark.parametrize("sname", sorted(PORT_DRY_SP))
def test_reduced_sp_cells_pinned_beside_reference(sname, monkeypatch):
    """The reduced Qwen3-8B cells under ``sp=True`` on the 4x2 mesh: the
    port's per-kind table and memory, and the reference's, pinned; a
    decode_32k cell captures as without ``sp`` in both packages."""
    from repro import configs as ref_configs
    from repro.compat import make_mesh
    from repro.core import hlo_parser
    from repro_torch.core.summary import summarize

    over = TRAIN if sname == "train_4k" else None
    reduced = configs.config
    monkeypatch.setattr(configs, "config",
                        lambda a, reduced_=False: reduced(a, reduced=True))
    cell = dryrun.capture_cell("qwen3_8b", sname, mesh_4x2(), sp=True,
                               train_overrides=over)
    assert _kinds(summarize(cell["ops"])) == PORT_DRY_SP[sname]
    assert tuple(cell["memory"][k] for k in MEM_KEYS) == PORT_MEM_SP[sname]

    ref_config = ref_configs.config
    monkeypatch.setattr(ref_configs, "config",
                        lambda a, reduced_=False: ref_config(a, reduced=True))
    lowered, _ = ref_dryrun.lower_cell(
        "qwen3_8b", sname, make_mesh((4, 2), ("data", "model")), sp=True,
        train_overrides=over)
    compiled = lowered.compile()
    ops = hlo_parser.parse_hlo_collectives(compiled.as_text())
    assert _kinds(hlo_parser.summarize(ops)) == REF_DRY_SP[sname]
    ref_mem = ref_dryrun._memory_stats(compiled)
    assert tuple(ref_mem[k] for k in MEM_KEYS) == REF_MEM_SP[sname]


# the recurrent and MoE families' prefill_32k under ``sp=True`` on the 4x2
# mesh, per kind (calls, payload bytes), beside the reference's
# ``lower_cell(..., sp=True).compile()``.  Both name ``seq -> model``; they
# differ in where the recurrences run.  The reference constrains the RG-LRU
# inputs to ("batch", "seq", "rnn") and the xLSTM up-projection to
# ("batch", "seq", "inner"), and its Sharder reuses no mesh axis, so the
# sequence stays split through the recurrence: GSPMD runs the scan on the
# sequence shards and passes the carries between them by
# collective-permutes, and reshards activations by all-to-alls (Grok-1's
# einsum dispatch moves its tokens the same way).  The port names ``None``
# for the sequence in ``REC_AXES`` (models/rglru.py) and ``INNER``
# (models/xlstm.py): each recurrence (the conv and RG-LRU scan; the mLSTM
# parallel form and the sLSTM loop) and each MoE local step takes the whole
# sequence, gathered along it over ``model`` (the 32-128 MiB gathers; a
# CUDA mesh's all-to-all to channel shards is an all-gather and a chunk on
# a CPU mesh), its products' partial sums reduce-scattered back onto the
# sequence shards (the 32-64 MiB reduce-scatters), and each weight gathered
# whole for the products on sequence shards (the small gathers, as for
# Qwen3-8B above).  DTensor cannot express GSPMD's permute-based scan
# without rewriting the recurrence, so both tables are pinned (ROADMAP
# queue 3 item 23).
PORT_SP_FAMILIES = {
    "recurrentgemma_2b": {"all-gather": (80, 1751293952),
                          "reduce-scatter": (10, 2281734144)},
    "xlstm_1_3b": {"all-gather": (58, 5172533248),
                   "reduce-scatter": (14, 2348843008),
                   "all-reduce": (2, 536870912)},
    "grok_1_314b": {"all-gather": (72, 2690603008),
                    "reduce-scatter": (6, 671121408)},
}
REF_SP_FAMILIES = {
    "recurrentgemma_2b": {"all-gather": (58, 809050112),
                          "all-to-all": (93, 3221716992),
                          "collective-permute": (69, 157696),
                          "all-reduce": (4, 20608)},
    "xlstm_1_3b": {"all-gather": (38, 1679900672),
                   "all-to-all": (12, 2684551168),
                   "collective-permute": (4, 14464),
                   "all-reduce": (6, 138957696)},
    "grok_1_314b": {"all-reduce": (6, 2658432),
                    "all-gather": (21, 622562304),
                    "all-to-all": (7, 11425284096),
                    "collective-permute": (1, 2048)},
}


@pytest.mark.parametrize("arch", sorted(PORT_SP_FAMILIES))
def test_reduced_sp_families_pinned_beside_reference(arch, monkeypatch):
    """The reduced RecurrentGemma-2B, xLSTM-1.3B and Grok-1 prefill_32k
    cells under ``sp=True`` on the 4x2 mesh: the port's per-kind table and
    the reference's, pinned side by side.  The port moves no carry between
    sequence shards (no permute): each recurrence runs on the whole
    sequence."""
    from repro import configs as ref_configs
    from repro.compat import make_mesh
    from repro.core import hlo_parser
    from repro_torch.core.summary import summarize

    reduced = configs.config
    monkeypatch.setattr(configs, "config",
                        lambda a, reduced_=False: reduced(a, reduced=True))
    cell = dryrun.capture_cell(arch, "prefill_32k", mesh_4x2(), sp=True)
    assert _kinds(summarize(cell["ops"])) == PORT_SP_FAMILIES[arch]

    ref_config = ref_configs.config
    monkeypatch.setattr(ref_configs, "config",
                        lambda a, reduced_=False: ref_config(a, reduced=True))
    lowered, _ = ref_dryrun.lower_cell(
        arch, "prefill_32k", make_mesh((4, 2), ("data", "model")), sp=True)
    ops = hlo_parser.parse_hlo_collectives(lowered.compile().as_text())
    assert _kinds(hlo_parser.summarize(ops)) == REF_SP_FAMILIES[arch]


def test_sequence_parallel_option(tmp_path):
    """``python -m repro_torch dryrun --sp --tag sp`` (the CLI, which
    forwards to the dry run) captures under the ``seq -> model`` rule and
    writes ``<arch>_<shape>_single_sp.json`` with the reference's keys
    (a child on the 16x16 CPU mesh, the reduced Qwen3-8B's prefill_32k:
    its tokens split over the sequence too, so a device holds 2048 of a
    sequence's 32768 ids, where without ``--sp`` it holds them all)."""
    child = _child("""
        from repro_torch import cli
        sys.exit(cli.main(['dryrun', '--arch', 'qwen3_8b', '--shape',
                           'prefill_32k', '--sp', '--tag', 'sp', '--device',
                           'cpu', '--out', sys.argv[1]]))
        """)
    proc = subprocess.run([sys.executable, "-c", child, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert [p.name for p in tmp_path.iterdir()] == [
        "qwen3_8b_prefill_32k_single_sp.json"]
    r = json.loads((tmp_path / "qwen3_8b_prefill_32k_single_sp.json")
                   .read_text())
    assert list(r) == _ref_result_keys()
    assert r["ok"] and r["tag"] == "sp" and r["devices"] == 256
    assert "sp" in inspect.signature(dryrun.capture_cell).parameters
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel import Sharder

    shd = Sharder(types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                        shape=(16, 16)))
    model = build_model(configs.config("qwen3_8b", reduced=True))
    params = sum(dryrun._local_bytes(t, shd, ax) for t, ax in zip(
        tree_leaves(model.shapes(device="meta")), tree_leaves(model.axes())))
    # int32 ids: 2 of the 32 sequences, 2048 of their 32768 positions
    assert r["memory"]["argument_bytes"] == params + 2 * 2048 * 4


def test_sp_reaches_both_meshes_children(monkeypatch):
    """``--mesh both --sp`` hands ``--sp`` (and the tag) to each mesh's
    child."""
    runs = []
    monkeypatch.setattr(dryrun.subprocess, "run", lambda cmd: runs.append(
        cmd) or types.SimpleNamespace(returncode=0))
    assert dryrun.main(["--all", "--mesh", "both", "--sp", "--tag", "sp",
                        "--device", "cpu"]) == 0
    assert [cmd[-1] for cmd in runs] == ["single", "multi"]
    for cmd in runs:
        assert "--sp" in cmd and "--all" in cmd
        assert cmd[cmd.index("--tag") + 1] == "sp"


def test_all_sp_cells_in_a_child(tmp_path):
    """``dryrun --all --sp --device cpu`` on the single pod (a 4x2 CPU
    mesh here), the reduced configs, each train preset cut to one
    microbatch (a microbatch repeats the first's collectives; the loop is
    held at two by the pinned train_4k tables above): every cell of every
    architecture is ok and writes its ``_sp`` file (~40 s)."""
    child = _child("""
        import dataclasses
        _train = c.train_config
        c.train_config = lambda arch: dataclasses.replace(_train(arch),
                                                          microbatches=1)
        sys.exit(dryrun.main(sys.argv[1:]))
        """, single=(4, 2))
    proc = subprocess.run(
        [sys.executable, "-c", child, "--all", "--sp", "--tag", "sp",
         "--device", "cpu", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    cells = configs.cells()
    assert proc.stdout.count("  ok: mem/dev=") == len(cells)
    for arch, sname in cells:
        r = json.loads((tmp_path / f"{arch}_{sname}_single_sp.json")
                       .read_text())
        assert r["ok"] and r["tag"] == "sp", (arch, sname)


def _chain(live, x):
    """A chain of allocations and frees whose live bytes are known: a and
    b fresh, a freed, a view of b (no bytes), a cat of b twice, b freed,
    a sum, the cat freed.  Returns the live bytes after each step."""
    import torch

    steps = []
    a = x * 2
    steps.append(live.live)
    b = a + 1
    steps.append(live.live)
    del a
    steps.append(live.live)
    c = b.t()
    steps.append(live.live)
    d = torch.cat([b, b], dim=1)
    steps.append(live.live)
    del b, c
    steps.append(live.live)
    e = d.sum(dim=1)
    steps.append(live.live)
    del d
    steps.append(live.live)
    return steps, e


@pytest.mark.parametrize("kind", ["plain", "dtensor"])
def test_live_bytes_exact_peak(kind):
    """``LiveBytes`` over a chain with a known peak, on one device's fake
    (16, 32) fp32 tensor (2048 bytes), or the same tensor as the local
    shard of a DTensor over the fake 4x2 mesh: the argument is never
    counted, a view adds nothing, every free drops at once, and the peak
    is the cat beside its input (2048 + 4096 bytes)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = mesh_4x2()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        x = torch.empty(16, 32)
        if kind == "dtensor":
            x = DTensor.from_local(x, mesh, [Shard(0), Replicate()])
    with fake, dryrun.LiveBytes({dryrun._storage_key(x)}) as live:
        steps, e = _chain(live, x)
    assert steps == [2048, 4096, 2048, 2048, 6144, 4096, 4160, 64]
    assert live.peak == 6144
    assert dryrun._local(e).shape == (16,)


def test_live_bytes_counts_a_collective_once():
    """A gather over data (an all-gather, then ``wait_tensor``, which
    returns a fresh fake tensor where a real process group returns its
    input) holds its (64, 32) fp32 result once: 8192 bytes, beside the
    2048 of its input until that is freed; the peak is the gathered
    tensor and the sum of it (8192 + 8192), and everything the step made
    is dropped with its last tensor."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.interceptor import CollectiveInterceptor

    mesh = mesh_4x2()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        x = DTensor.from_local(torch.empty(16, 32), mesh,
                               [Shard(0), Replicate()])
    steps = []
    with fake, CollectiveInterceptor(mesh, cost=True) as icpt, \
            dryrun.LiveBytes({dryrun._storage_key(x)}) as live:
        a = x * 2
        steps.append(live.live)
        g = a.redistribute(mesh, [Replicate(), Replicate()])
        steps.append(live.live)
        del a
        steps.append(live.live)
        h = g + 1
        steps.append(live.live)
        del g
        steps.append(live.live)
        del h
        steps.append(live.live)
    assert [op.kind for op in icpt.ops] == ["all-gather"]
    assert steps == [2048, 10240, 8192, 16384, 8192, 0]
    assert live.peak == 16384 and live.held == {}
