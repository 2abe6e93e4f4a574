"""Split-K flash decode's arithmetic on the CPU: the partition of the live
range and the log-sum-exp combine (``ref.decode_split_ref``, which the CUDA
kernels of ``csrc/flash_decode.cu`` compute), and the host's choice of the
number of splits (``ops.num_splits``).

Inputs are made with numpy from a fixed seed and handed to both frameworks;
everything is fp32, so the combine agrees with one softmax over all live
keys up to the order of fp32 sums (1e-6).  The CUDA kernels themselves run
only on the card (``chip_smoke.py``).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ref import decode_ref as jax_decode_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import (decode_ref,
                                                  decode_split_ref,
                                                  split_range)

LAYOUTS = {"linear": 2176, "ring": 2048}   # cache slots L
CACHE_LENS = (1, 15, 16, 17, 129, 160, 2048, 2148)
NSPLITS = (1, 3, 32, 300)                  # 300: more than the live slots


def _inputs(lmax, seed, b=2, h=4, kvh=2, dh=16):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, dh), (b, lmax, kvh, dh), (b, lmax, kvh, dh))]
    return [torch.from_numpy(a) for a in arrs], [jnp.asarray(a)
                                                 for a in arrs]


def _live(clen, lmax, window):
    return max(0, min(clen, lmax) - (max(0, clen - window) if window else 0))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("clen", CACHE_LENS)
@pytest.mark.parametrize("nsplit", NSPLITS)
def test_split_combine_matches_references(layout, window, clen, nsplit):
    lmax = LAYOUTS[layout]
    (qt, kt, vt), (qj, kj, vj) = _inputs(lmax, seed=clen + window)
    cl = torch.tensor(clen, dtype=torch.int32)
    got = decode_split_ref(qt, kt, vt, cl, window=window, nsplit=nsplit)
    assert got.shape == qt.shape and got.dtype == torch.float32
    if _live(clen, lmax, window) == 0:
        # no live key (window 48 ending past a 2048-slot ring): every split
        # is empty and the combine gives 0, as the Pallas kernel's
        # acc / max(l, 1e-30) does; the plain softmax spreads over all slots
        assert torch.equal(got, torch.zeros_like(got))
        return
    want = decode_ref(qt, kt, vt, cl, window=window)
    assert float((got - want).abs().max()) < 1e-6
    ref = np.asarray(jax_decode_ref(qj, kj, vj, jnp.int32(clen),
                                    window=window))
    assert float(np.abs(got.numpy() - ref).max()) < 1e-6


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("clen", CACHE_LENS)
@pytest.mark.parametrize("nsplit", NSPLITS)
def test_partition_covers_live_range_once(window, clen, nsplit):
    """The splits' ranges tile the live range in order, each a multiple of
    16 keys but the last, with no key twice; splits past it are empty."""
    lmax = LAYOUTS["ring"]
    hi = min(clen, lmax)
    lo = max(0, clen - window) if window else 0
    keys, chunks = [], []
    for s in range(nsplit):
        a, b = split_range(clen, lmax, window, nsplit, s)
        if a < b:
            chunks.append(b - a)
            keys.extend(range(a, b))
    assert keys == list(range(lo, hi))
    assert all(c % 16 == 0 for c in chunks[:-1])
    assert len(chunks) <= -(-max(0, hi - lo) // 16)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float16, 3e-2)])
def test_split_combine_rounds_once_to_q_dtype(dtype, tol):
    """Half-precision q and caches: the partials stay fp32 and only the
    output is rounded, so it is within one rounding of the fp32 result."""
    (qt, kt, vt), _ = _inputs(2048, seed=3)
    qt, kt, vt = qt.to(dtype), kt.to(dtype), vt.to(dtype)
    cl = torch.tensor(2148, dtype=torch.int32)
    got = decode_split_ref(qt, kt, vt, cl, nsplit=32)
    assert got.dtype == dtype
    want = decode_ref(qt.float(), kt.float(), vt.float(), cl)
    assert float((got.float() - want).abs().max()) < tol


@pytest.mark.parametrize("sms", [1, 16, 132, 144])
@pytest.mark.parametrize("b,kvh,lmax", [
    (8, 1, 2048), (8, 8, 256), (8, 8, 160), (1, 1, 16), (1, 1, 1),
    (64, 8, 4096), (2, 4, 100), (300, 1, 2048)])
def test_num_splits_choice(b, kvh, lmax, sms):
    n = fd_ops.num_splits(b, kvh, lmax, sms)
    assert 1 <= n <= -(-lmax // 16)
    # about two CTAs an SM: never more than that unless one split each
    assert n == 1 or b * kvh * n <= 2 * sms
    assert n & (n - 1) == 0 or n == -(-lmax // 16)


def test_num_splits_ignores_cache_len():
    """The host's choice takes shapes and the SM count only: no cache_len
    reaches it, so the host never reads the device's counter."""
    assert list(inspect.signature(fd_ops.num_splits).parameters) == [
        "b", "kvh", "lmax", "sms"]
    # the serve paths' shapes on an H100 (132 SMs)
    assert fd_ops.num_splits(8, 1, 2048, 132) == 32     # RecurrentGemma
    assert fd_ops.num_splits(8, 8, 256, 132) == 4       # Qwen3-8B
    assert fd_ops.num_splits(8, 1, 160, 132) == 10      # 160-slot ring


@pytest.mark.parametrize("g,dh,want", [
    (4, 128, 1), (1, 128, 1), (10, 256, 1), (8, 128, 1), (1, 64, 1),
    (4, 64, 1), (48, 128, 3), (64, 128, 4), (41, 128, 41), (30, 256, 3)])
def test_head_blocks(g, dh, want):
    """A kv head's query heads go to one CTA when their outputs fit its
    2560 (Qwen3-8B 4 x 128, the MHA configs, RecurrentGemma-2B's 10 x 256,
    Chameleon-34B 8 x 128); wider groups (Granite-20B's MQA, 48 x 128) are
    cut into the fewest equal blocks that fit, one CTA each."""
    n = fd_ops.head_blocks(g, dh)
    assert n == want
    assert g % n == 0 and g // n * dh <= fd_ops.MAX_GROUP_WIDTH
    assert all(g % m or g // m * dh > fd_ops.MAX_GROUP_WIDTH
               for m in range(1, n))
