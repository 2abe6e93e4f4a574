"""The context-parallel attention branch against the reference.

Where heads do not divide the model axis and one shard's fp32 score block
is under 2 GiB, both packages shard q over the sequence (``attn_seq``),
expand and replicate k and v, and compute one score block a shard; else
they pad heads up to a multiple of ``tp``.

* The choice, on the production mesh (``data=16``, ``model=16``, as
  ``repro.launch.mesh``): each package's ``attention_block`` is driven on
  stand-ins (jax's ``eval_shape``, torch's ``meta`` tensors) through a
  Sharder bound to that mesh's sizes, at a whole step's batch and sequence
  of each cell, and the branch it takes is read from the attention call.
* The arithmetic: the port runs the kernel on each sequence shard with its
  global position as ``q_offset`` (the reference's program sees the global
  array and needs none).  Split into ``tp`` shards through the plain
  version, a causal and a windowed problem equal the unsplit attention
  and the reference's ``chunked_attention`` within ``2e-5`` in fp32.
* The capture: the reduced MusicGen config with 3 heads on the 4x2 mesh
  takes the branch in both packages.  Its per-kind tables are pinned beside
  the reference's (DTensor against GSPMD, as in
  ``test_torch_configs_transformer.py``), and beside the port's padded
  path, whose gathers of the padded heads it no longer shows.
"""
import collections
import contextlib
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import sweep as ref_sweep
from repro.kernels.flash_attention import ops as ref_flash_ops
from repro.models import attention as ref_attention
from repro.models.attention import chunked_attention as ref_chunked
from repro.models.common import SHAPES_BY_NAME as REF_SHAPES
from repro.parallel import Sharder as RefSharder
from repro_torch import configs, sweep
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention
from repro_torch.models.common import SHAPES_BY_NAME
from repro_torch.parallel import Sharder
from torch_fixtures import mesh_4x2, ref_serve_cell, ref_train_cell

TOL = 2e-5
PRODUCTION = {"data": 16, "model": 16}
CP_CELLS = {("musicgen_medium", "train_4k"),
            ("recurrentgemma_2b", "train_4k")}


# ---------------------------------------------------------------------------
# the choice on the production mesh
# ---------------------------------------------------------------------------
class _RefMeshSizes(RefSharder):
    """The reference's Sharder bound to mesh sizes alone (no devices back
    it): its constraints are the identity, their layouts recorded."""

    def __init__(self, sizes):
        mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                     devices=np.empty(tuple(sizes.values())))
        super().__init__(mesh)
        self.layouts = []

    def constraint(self, x, axes):
        self.layouts.append(tuple(axes))
        return x


class _PortMeshSizes(Sharder):
    """The port's Sharder bound to mesh sizes alone, as rank 0: its
    constraints are the identity, their layouts recorded, and ``local``
    runs on the tensors given."""

    def __init__(self, sizes):
        super().__init__()
        self.mesh_sizes = dict(sizes)
        self.mesh = types.SimpleNamespace(get_local_rank=lambda axis: 0)
        self.layouts = []

    def constraint(self, x, axes):
        self.layouts.append(tuple(axes))
        return x

    def local(self, fn, args, axes, out=0):
        return fn(*args)


def _branch(shd) -> str:
    """'cp' where the block laid q out by sequence, else 'pad'."""
    return "cp" if attention.CP_AXES in shd.layouts else "pad"


def _ref_branch(cfg, b, s):
    """The branch the reference's ``attention_block`` takes for an input
    of ``(b, s, d)`` (its attention call a stand-in)."""
    def attend(q, k, v, **kw):
        return jnp.zeros_like(q)

    dt = jnp.bfloat16
    params = {k: jax.ShapeDtypeStruct(spec.shape, dt)
              for k, spec in ref_attention.attn_spec(cfg).items()}
    shd = _RefMeshSizes(PRODUCTION)
    with mock.patch.object(ref_flash_ops, "attend", attend):
        jax.eval_shape(lambda p, x: ref_attention.attention_block(
            p, x, cfg, shd)[0], params,
            jax.ShapeDtypeStruct((b, s, cfg.d_model), dt))
    return _branch(shd)


def _port_branch(cfg, b, s):
    """The same for the port's ``attention_block``, on ``meta`` tensors."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    params = {k: meta(*spec.shape)
              for k, spec in attention.attn_spec(cfg).items()}
    shd = _PortMeshSizes(PRODUCTION)
    with mock.patch.object(flash_ops, "attend",
                           lambda q, k, v, **kw: torch.empty_like(q)):
        attention.attention_block(params, meta(b, s, cfg.d_model), cfg, shd)
    return _branch(shd)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_branch_on_the_production_mesh(arch, shape):
    """Both packages take the same branch at every (arch, shape) cell with
    a sequence (decode steps read the cache); only MusicGen-medium (24
    heads) and RecurrentGemma-2B (10) at ``train_4k`` take it, the rest
    divide 16 or exceed the 2 GiB score block."""
    cfg = configs.config(arch)
    sh = SHAPES_BY_NAME[shape]
    b, s = sh.global_batch, sh.seq_len
    assert (REF_SHAPES[shape].global_batch, REF_SHAPES[shape].seq_len) == \
        (b, s)
    ref = _ref_branch(ref_configs.config(arch), b, s)
    port = _port_branch(cfg, b, s)
    want = "cp" if (arch, shape) in CP_CELLS else "pad"
    assert port == ref == want
    if cfg.n_heads % 16 == 0:      # Qwen3-8B and the others that divide
        assert not attention.use_context_parallel(b, s, cfg.n_heads, 16, 16)


def test_musicgen_train_score_block():
    """MusicGen-medium at ``train_4k``: 16 sequences a data shard x 24
    heads x 256 query rows x 4096 keys x 4 bytes = 1.61 GB, under 2 GiB."""
    b_loc, nh, s = 256 // 16, 24, 4096
    assert b_loc * nh * (s // 16) * s * 4 == 1_610_612_736 < 2 << 30
    assert attention.use_context_parallel(256, s, nh, 16, 16)
    assert not attention.use_context_parallel(256, s, nh, 1, 16)
    # twice the rows a data shard would exceed the limit: heads are padded
    assert not attention.use_context_parallel(512, s, nh, 16, 16)


# ---------------------------------------------------------------------------
# the shard emulation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 24], ids=["causal", "window24"])
def test_sequence_shards_at_their_offsets(window):
    """``tp`` q shards, each at ``context_parallel_offset``'s position,
    through the plain version: concatenated, the unsplit attention and the
    reference's ``chunked_attention`` (GQA k/v expanded first, as the
    branch does)."""
    tp, b, s, h, kvh, dh = 4, 2, 64, 6, 2, 16
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, s, n, dh)).astype(np.float32)
               for n in (h, kvh, kvh))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tk, tv = attention._expand_kv(tk, h), attention._expand_kv(tv, h)
    shards = []
    for r in range(tp):
        mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     shape=(1, tp),
                                     get_local_rank=lambda axis, r=r: r)
        off = attention.context_parallel_offset(Sharder(mesh), s)
        assert off == r * s // tp
        shards.append(flash_ops.attend(
            tq[:, off:off + s // tp].contiguous(), tk, tv, causal=True,
            window=window, q_offset=off))
    got = torch.cat(shards, dim=1).numpy()
    whole = flash_ops.attend(tq, tk, tv, causal=True, window=window).numpy()
    ref = np.asarray(ref_chunked(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=window,
                                 q_chunk=s))
    np.testing.assert_allclose(got, whole, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_offset_without_a_sequence_shard():
    """A sequence the model axis does not divide stays whole (the
    Sharder's fallback): every shard starts at 0."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 4), get_local_rank=lambda a: 3)
    assert attention.context_parallel_offset(Sharder(mesh), 30) == 0
    assert attention.context_parallel_offset(Sharder(mesh), 32) == 24


# ---------------------------------------------------------------------------
# the capture: 3 heads on the 4x2 mesh
# ---------------------------------------------------------------------------
def _three_heads(cfgs):
    return cfgs.reduce_config(cfgs.config("musicgen_medium"), n_heads=3,
                              n_kv_heads=3)


# kind -> (calls, payload bytes per device) by step: the port's on the fake
# CPU 4x2 mesh and the reference's on its 4x2 host mesh
PORT_CP = {
    "train": {"all-gather": (109, 11534336), "all-reduce": (29, 1380424),
              "reduce-scatter": (25, 1425408)},
    "prefill": {"all-gather": (45, 1935360), "all-reduce": (8, 262144),
                "reduce-scatter": (1, 8192)},
    "decode": {"all-gather": (49, 140288), "all-reduce": (16, 15104),
               "reduce-scatter": (17, 59392)},
}
REF_CP = {
    "train": {"all-gather": (116, 8421376), "all-reduce": (32, 2504376),
              "all-to-all": (24, 9568256), "collective-permute": (16, 1048576)},
    "prefill": {"all-gather": (20, 1114112), "all-reduce": (6, 132128),
                "collective-permute": (9, 262656)},
    "decode": {"all-reduce": (16, 7936), "collective-permute": (8, 8192)},
}
# (step, kind, per-device dims, payload bytes) -> calls that only one of
# the port's two paths issues: the branch gathers the attention output's
# sequence shards (and, in the backward, their gradient's); the padded path
# gathers the padded heads' shards (2 of 4 heads a model shard) instead
ONLY_CP = {("prefill", "all-gather", (4, 16, 48), 6144): 4,
           ("train", "all-gather", (4, 32, 48), 12288): 8,
           ("train", "all-gather", (4, 32, 3, 16), 12288): 4}
ONLY_PADDED = {("prefill", "all-gather", (4, 32, 2, 16), 8192): 4,
               ("train", "all-gather", (4, 64, 2, 16), 16384): 20}

_CAPTURES: dict = {}


def _port_capture(padded: bool = False):
    """(per-kind tables, op rows, shard shapes the kernel saw)."""
    if padded not in _CAPTURES:
        cfg = _three_heads(configs)
        seen, attend = [], flash_ops.attend

        def spy(q, k, v, **kw):
            seen.append((tuple(q.shape), tuple(k.shape)))
            return attend(q, k, v, **kw)

        cells = {"train": lambda m: sweep.train_cell(m, cfg, global_batch=8,
                                                     seq_len=64),
                 "serve": lambda m: sweep.serve_cell(
                     m, cfg, batch=8, prompt_len=32, max_len=48)}
        patches = [mock.patch.object(flash_ops, "attend", spy)]
        if padded:
            patches.append(mock.patch.object(
                attention, "use_context_parallel", lambda *a: False))
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            reps = {k: sweep._monitor_cell(c, mesh_4x2(), "cp")
                    for k, c in cells.items()}
        tables = {"train": _kinds(reps["train"].compiled_summary)}
        tables.update({ph: _kinds(s) for ph, s in
                       reps["serve"].phase_summaries().items()})
        rows = collections.Counter(
            ("train" if op.phase == "main" else op.phase, op.kind,
             op.result_shapes[0].dims, op.payload_bytes)
            for rep in reps.values() for op in rep.compiled_ops)
        _CAPTURES[padded] = (tables, rows, seen)
    return _CAPTURES[padded]


def _kinds(summary):
    return {k: (r["calls"], r["payload_bytes"]) for k, r in summary.items()}


def test_reduced_three_heads_take_the_branch_in_both():
    """The port's kernel sees each shard's half of the sequence with the 3
    heads unpadded and k/v whole (prefill 32, train 64 a sequence); the
    reference's attention sees the global q unpadded in one block."""
    _, _, seen = _port_capture()
    assert set(seen) == {((2, 16, 3, 16), (2, 32, 3, 16)),
                         ((2, 32, 3, 16), (2, 64, 3, 16))}
    cfg, chunks = _three_heads(ref_configs), []
    attend = ref_flash_ops.attend

    def spy(q, k, v, **kw):
        chunks.append((q.shape, kw.get("q_chunk")))
        return attend(q, k, v, **kw)

    mesh = ref_sweep.build_mesh("4x2")
    with mock.patch.object(ref_flash_ops, "attend", spy):
        ref_sweep._monitor_cell(ref_serve_cell(cfg)(mesh), mesh, "cp", "ring")
    assert set(chunks) == {((8, 32, 3, 16), 32)}


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_three_heads_tables_pinned_beside_reference(step):
    tables, _, _ = _port_capture()
    assert tables[step] == PORT_CP[step]
    mesh = ref_sweep.build_mesh("4x2")
    cfg = _three_heads(ref_configs)
    key = "ref"
    if key not in _CAPTURES:
        reps = {k: ref_sweep._monitor_cell(b(cfg)(mesh), mesh, "cp", "ring")
                for k, b in (("train", ref_train_cell), ("serve", ref_serve_cell))}
        out = {"train": _kinds(reps["train"].compiled_summary)}
        out.update({ph: _kinds(s) for ph, s in
                    reps["serve"].phase_summaries().items()})
        _CAPTURES[key] = out
    assert _CAPTURES[key][step] == REF_CP[step]


def test_branch_drops_the_head_padding_gathers():
    """Op for op, the branch's capture against the padded path's: the
    padded heads' gathers are gone, the sequence shards' gathers take their
    place, and nothing else differs."""
    _, cp, _ = _port_capture()
    _, padded, _ = _port_capture(padded=True)
    assert dict(cp - padded) == ONLY_CP
    assert dict(padded - cp) == ONLY_PADDED
