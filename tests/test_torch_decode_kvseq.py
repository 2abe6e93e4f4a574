"""The sequence-sharded decode cache (``kv_seq``) against the reference.

The reference lays the KV cache out as ``("batch", "kv_seq", "kv_heads",
None)`` and lets GSPMD partition its decode einsums over the sharded
sequence.  The port decodes each rank's sequence shard with the kernel's
partial (``ops.decode_attend_partial``, plainly ``ref.decode_partial_ref``
on the CPU) and merges the shards' ``(out, lse)`` by log-sum-exp
(``ref.lse_combine``; in the model ``attention.merge_partials``, two
all-reduces over ``model``).

The fake process group moves no data, so the ranks are simulated in one
process: the cache is cut into P sequence shards, P in {1, 2, 4, 16}, each
decoded at its ``kv_offset``, and the partials merged.  Inputs are seeded
numpy fp32; the merge is held to the JAX reference's ``decode_attention``
and to the port's unsplit ``decode_ref`` at rtol = atol = 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.compat import make_mesh
from repro.models import build_model as ref_build_model
from repro.models.attention import decode_attention as jax_decode_attention
from repro.parallel import Sharder as RefSharder
from repro_torch import configs
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import (decode_partial_ref,
                                                  decode_ref, lse_combine,
                                                  split_range)
from repro_torch.models import attention, build_model
from repro_torch.models.common import tree_leaves
from repro_torch.parallel import Sharder
from torch_fixtures import mesh_4x2

TOL = 2e-5
B, L, DH = 2, 64, 16
LAYOUTS = {"gqa": (8, 2), "mqa": (4, 1), "mha": (4, 4)}
SHARDS = (1, 2, 4, 16)


def _inputs(h, kvh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, h, DH), dtype=np.float32)
    k = rng.standard_normal((B, L, kvh, DH), dtype=np.float32)
    v = rng.standard_normal((B, L, kvh, DH), dtype=np.float32)
    return q, k, v


def _merged(q, k, v, cache_len, p, *, window=0, ring=False, partial=None):
    """The P simulated ranks' partials, merged."""
    partial = partial or (lambda qt, ks, vs, off: decode_partial_ref(
        qt, ks, vs, cache_len, kv_offset=off, lmax=L, window=window,
        ring=ring))
    n = L // p
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    parts = [partial(qt, kt[:, r * n:(r + 1) * n], vt[:, r * n:(r + 1) * n],
                     r * n) for r in range(p)]
    return parts, lse_combine([o for o, _ in parts], [l for _, l in parts])


def _jax(q, k, v, cache_len, window, ring):
    out = jax_decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k),
                               jnp.asarray(v), jnp.int32(cache_len),
                               window=window, ring=ring)
    return np.asarray(out)[:, 0]


# (cache_len, window, ring): the live range ends in the first, a middle or
# the last shard; a window leaves the first shards with no live key; a ring
# before and after it wraps, with and without a window shorter than it
CASES = [(3, 0, False), (30, 0, False), (64, 0, False), (30, 16, False),
         (64, 16, False), (5, 0, True), (40, 0, True), (100, 0, True),
         (100, 40, True), (64, 24, True)]


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("cache_len,window,ring", CASES)
def test_shard_merge_matches_reference(cache_len, window, ring, layout, p):
    """The P shards' merged partials equal the JAX reference's decode over
    the whole cache, and (linear caches) the port's unsplit plain
    version."""
    h, kvh = LAYOUTS[layout]
    q, k, v = _inputs(h, kvh, seed=cache_len + p)
    parts, (out, lse) = _merged(q, k, v, cache_len, p, window=window,
                                ring=ring)
    want = _jax(q, k, v, cache_len, window, ring)
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    assert torch.isfinite(lse).all()
    if not ring:
        unsplit = decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), cache_len, window=window)
        np.testing.assert_allclose(out.numpy(), unsplit.numpy(), rtol=TOL,
                                   atol=TOL)
    for o, l in parts:        # a shard with no live key: exactly 0, -inf
        dead = torch.isneginf(l)
        assert not torch.isnan(o).any() and not torch.isnan(l).any()
        assert (o[dead] == 0).all()


@pytest.mark.parametrize("cache_len,window,ring,dead_shards", [
    (3, 0, False, [1, 2, 3]), (64, 16, False, [0, 1, 2]),
    (30, 0, True, [2, 3])])
def test_dead_shards_are_exact(cache_len, window, ring, dead_shards):
    """Shards with no live key give lse -inf and out 0, and the merge with
    them equals the merge of the live shards alone, bit for bit."""
    q, k, v = _inputs(8, 2, seed=7)
    parts, (out, lse) = _merged(q, k, v, cache_len, 4, window=window,
                                ring=ring)
    dead = [r for r, (_, l) in enumerate(parts) if torch.isneginf(l).all()]
    assert dead == dead_shards
    for r in dead:
        assert (parts[r][0] == 0).all()
    live = [parts[r] for r in range(4) if r not in dead]
    out2, lse2 = lse_combine([o for o, _ in live], [l for _, l in live])
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    # no live key anywhere: zeros and -inf, no NaN
    none_out, none_lse = lse_combine([parts[r][0] for r in dead],
                                     [parts[r][1] for r in dead])
    assert (none_out == 0).all() and torch.isneginf(none_lse).all()


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("cache_len,window", [(3, 0), (30, 16), (64, 0),
                                              (100, 0)])
def test_partial_op_on_cpu_is_the_plain_partial(cache_len, window, p):
    """``decode_attend_partial`` on CPU tensors: the plain partial, fp32,
    at each shard's ``kv_offset`` (a wrapped ring with window >= L passes
    window 0 as the model does: every slot below min(cache_len, L))."""
    q, k, v = _inputs(8, 2, seed=p)
    cl = torch.tensor(cache_len, dtype=torch.int32)

    def op(qt, ks, vs, off):
        return fd_ops.decode_attend_partial(qt, ks, vs, cl, kv_offset=off,
                                            lmax=L, window=window)

    parts, (out, _) = _merged(q, k, v, cache_len, p, window=window,
                              partial=op)
    ref_parts, _ = _merged(q, k, v, cache_len, p, window=window)
    for (o, l), (ro, rl) in zip(parts, ref_parts):
        assert o.dtype == l.dtype == torch.float32
        assert torch.equal(o, ro) and torch.equal(l, rl)
    want = _jax(q, k, v, cache_len, window, ring=cache_len > L)
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)


def test_partial_op_checks_and_refuses_a_backward():
    q, k, v = (torch.from_numpy(x) for x in _inputs(8, 2))
    cl = torch.tensor(9, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not lie in a cache"):
        fd_ops.decode_attend_partial(q, k[:, :32], v[:, :32], cl,
                                     kv_offset=48, lmax=L)
    with pytest.raises(TypeError, match="one-element int32"):
        fd_ops.decode_attend_partial(q, k, v, 9, kv_offset=0, lmax=L)
    qg = q.clone().requires_grad_()
    out, _ = fd_ops.decode_attend_partial(qg, k, v, cl, kv_offset=0, lmax=L)
    with pytest.raises(RuntimeError, match="no gradient"):
        out.sum().backward()


@pytest.mark.parametrize("cache_len,window,lglob,off,lmax", [
    (129, 0, 160, 0, 10), (129, 0, 160, 120, 10), (129, 0, 160, 130, 10),
    (2148, 0, 2048, 1920, 128), (90, 32, 256, 32, 32), (90, 32, 256, 64, 32),
    (5, 0, 64, 0, 64)])
@pytest.mark.parametrize("nsplit", [1, 2, 8])
def test_split_range_clips_to_the_shard(cache_len, window, lglob, off, lmax,
                                        nsplit):
    """The kernel's split ranges of a shard cover exactly the shard's live
    slots, in chunks of 16 keys (a shard of 10 slots included)."""
    live_lo = max(0, cache_len - window) if window else 0
    live = {j - off for j in range(live_lo, min(cache_len, lglob))
            if off <= j < off + lmax}
    got = set()
    for s in range(nsplit):
        lo, hi = split_range(cache_len, lmax, window, nsplit, s,
                             kv_offset=off, lglob=lglob)
        if lo < hi:
            assert 0 <= lo and hi <= lmax and not got & set(range(lo, hi))
            got |= set(range(lo, hi))
    assert got == live


def test_split_range_unsharded_is_unchanged():
    """kv_offset 0 and lglob = L: the unsharded kernel's ranges."""
    for clen, lmax, win, ns in [(129, 160, 0, 10), (2148, 2048, 0, 32),
                                (90, 256, 32, 4)]:
        for s in range(ns):
            assert split_range(clen, lmax, win, ns, s) == split_range(
                clen, lmax, win, ns, s, kv_offset=0, lglob=lmax)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("slot", [0, 17, 63])
def test_masked_write_touches_only_the_owner(p, slot):
    """``write_owned_slot`` on each simulated rank: the owner's slot takes
    the new row, every other shard stays bit for bit as it was."""
    rng = np.random.default_rng(slot)
    cache = torch.from_numpy(rng.standard_normal((B, L, 2, DH),
                                                 dtype=np.float32))
    new = torch.from_numpy(rng.standard_normal((B, 1, 2, DH),
                                               dtype=np.float32))
    n = L // p
    for r in range(p):
        shard = cache[:, r * n:(r + 1) * n].clone()
        before = shard.clone()
        attention.write_owned_slot(
            shard, new, torch.tensor(slot - r * n, dtype=torch.int32))
        if r * n <= slot < (r + 1) * n:
            want = before.clone()
            want[:, slot - r * n] = new[:, 0]
            assert torch.equal(shard, want)
        else:
            assert torch.equal(shard, before)


@pytest.mark.parametrize("p", SHARDS)
def test_model_merge_is_lse_combine(p, monkeypatch):
    """``attention.merge_partials``, with its two all-reduces run over P
    simulated ranks stacked on a leading dim, gives every rank the merged
    output of ``lse_combine``."""
    calls = []

    def all_reduce(t, op, group):
        calls.append((op, tuple(t.shape[1:])))
        red = t.amax(0) if op == "max" else t.sum(0)
        return red.expand_as(t)

    monkeypatch.setattr(funcol, "all_reduce", all_reduce)
    q, k, v = _inputs(8, 2, seed=p)
    parts, (want, _) = _merged(q, k, v, 30, p, window=16)
    got = attention.merge_partials(torch.stack([o for o, _ in parts]),
                                   torch.stack([l for _, l in parts]), None)
    assert calls == [("max", (B, 8)), ("sum", (B, 8, DH + 1))]
    for r in range(p):
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def _cache_specs(arch, max_len):
    cfg = configs.config(arch, reduced=True)
    model = build_model(cfg)
    rmodel = ref_build_model(ref_configs.config(arch, reduced=True))
    shapes = tree_leaves(model.cache_shapes(8, max_len, device="meta"))
    axes = tree_leaves(model.cache_axes())
    rshapes = jax.tree.leaves(rmodel.cache_shapes(8, max_len))
    return shapes, axes, rshapes


@pytest.mark.parametrize("arch,max_len", [("qwen3_8b", 48),
                                          ("recurrentgemma_2b", 48),
                                          ("recurrentgemma_2b", 16)])
def test_cache_layout_is_the_references(arch, max_len):
    """Every cache leaf's mesh axes on the 4x2 mesh equal the reference's
    ``Sharder.spec``; the k/v caches are ``Shard`` over ``model`` on their
    sequence dim (the serve cell's 48-slot cache, and RecurrentGemma's ring
    of 32 (its window) and of 16 slots)."""
    shapes, axes, rshapes = _cache_specs(arch, max_len)
    assert [tuple(t.shape) for t in shapes] == [s.shape for s in rshapes]
    port = Sharder(mesh_4x2())
    ref = RefSharder(make_mesh((4, 2), ("data", "model")))
    kv = 0
    for t, ax in zip(shapes, axes):
        assert port.spec(t.shape, ax) == tuple(ref.spec(t.shape, ax))
        if "kv_seq" in ax:
            kv += 1
            seq = ax.index("kv_seq")
            assert port.spec(t.shape, ax)[seq] == "model"
            pl = port.placements(t.shape, ax)
            assert pl == (Shard(seq - 1), Shard(seq))
    assert kv == 2
    assert attention.kv_cache_axes()["k"] == ("batch", "kv_seq", "kv_heads",
                                              None)


def test_sequence_parallel_rule_is_the_references():
    """``enable_sp`` maps ``seq`` to ``model`` as the reference's does."""
    port = Sharder(mesh_4x2(), enable_sp=True)
    ref = RefSharder(make_mesh((4, 2), ("data", "model")), enable_sp=True)
    for shape, ax in [((8, 64, 32), ("batch", "seq", None)),
                      ((8, 64, 32), ("batch", "seq", "mlp")),
                      ((8, 1, 32), ("batch", "seq", "heads"))]:
        assert port.spec(shape, ax) == tuple(ref.spec(shape, ax))
    assert port.spec((8, 64, 32), ("batch", "seq", None)) == \
        ("data", "model", None)
    assert Sharder(mesh_4x2()).spec((8, 64, 32), ("batch", "seq", None)) \
        == ("data", None, None)
    assert port.placements((8, 64, 32), ("batch", "seq", None)) == \
        (Shard(0), Shard(1))
    assert Sharder(mesh_4x2()).placements((8, 64), ("batch", None)) == \
        (Shard(0), Replicate())


def test_axis_coordinate_and_group():
    """The model-axis coordinate and group the merge runs on (this process
    is rank 0 of the fake group)."""
    shd = Sharder(mesh_4x2())
    assert shd.coordinate("model") == 0 and shd.coordinate("pod") == 0
    assert Sharder().coordinate("model") == 0
    import torch.distributed as dist
    assert dist.get_process_group_ranks(shd.group("model")) == [0, 1]
    assert dist.get_process_group_ranks(shd.group("data")) == [0, 2, 4, 6]


def test_decode_capture_merges_over_model():
    """A decode step captured on the 4x2 mesh runs the partial kernel op
    once a layer on the local shard (24 of 48 slots) and merges with two
    all-reduces a layer over ``model``: a max of the (B/4, H) lse and a
    sum of the packed (B/4, H, dh + 1) output."""
    from repro_torch import sweep

    cfg = configs.config("qwen3_8b", reduced=True)
    rep = sweep._monitor_cell(
        lambda m: sweep.serve_cell(m, cfg, batch=8, prompt_len=32,
                                   max_len=48), mesh_4x2(), "kvseq")
    model_groups = [[0, 1], [2, 3], [4, 5], [6, 7]]
    dec = [op for op in rep.compiled_ops if op.phase == "decode"
           and op.kind == "all-reduce" and op.replica_groups == model_groups]
    h, dh = cfg.n_heads, cfg.dh
    lse = [op for op in dec if op.result_shapes[0].dims == (2, h)]
    packed = [op for op in dec if op.result_shapes[0].dims == (2, h, dh + 1)]
    assert len(lse) == len(packed) == cfg.n_layers
    assert all(op.result_shapes[0].dtype == "f32" for op in lse + packed)


@pytest.mark.parametrize("p", SHARDS)
def test_partial_flops_sum_to_the_whole_cache(p):
    """The partial op's FLOP count is the decode formula over the shard:
    P shards sum to ``flash_decode_flop`` of the whole cache, so a decode
    captured at ``model = 1`` counts what it counted before."""
    from repro_torch.core.op_cost import (flash_decode_flop,
                                          flash_decode_partial_flop)

    q, k = (8, 32, 128), (8, 32768, 8, 128)
    shard = (8, 32768 // p, 8, 128)
    assert p * flash_decode_partial_flop(q, shard, shard, (), 0, 32768, 0) \
        == flash_decode_flop(q, k, k, (), 0) == 4 * 8 * 32 * 32768 * 128
