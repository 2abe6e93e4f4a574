"""The port's kernels (``repro_torch.kernels``) against the JAX reference.

On the CPU every wrapper runs its kernel's plain PyTorch version; these tests
hold those plain versions to the reference's oracles (``repro.kernels.*.ref``),
to the reference model's plain attention paths, and -- one case per kernel --
to the Pallas kernel itself in interpret mode.  Inputs are made with numpy
from a fixed seed and handed to both frameworks.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in fp32 (sum order), 2e-2 (prefill) and
3e-2 (decode) in bf16, 4e-6 for RMSNorm (one fp32 rounding of the reduce).
The CUDA kernels themselves run only on the card (``chip_smoke.py``); the
RG-LRU recurrence's tests are in ``tests/test_torch_rglru.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.flash_decode.ref import decode_ref as jax_decode_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.models import attention as jax_attention
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import attention as torch_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype="float32", shift=0.0):
    """The same values as a jax array and a torch tensor (bf16 rounds the
    fp32 draw the same way in both: round to nearest even)."""
    a = (rng.standard_normal(shape) + shift).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _err(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j.astype(jnp.float32))
                               - t.float().numpy())))


class TestRMSNorm:
    @pytest.mark.parametrize("shape,dtype", [
        ((4, 64, 128), "float32"),
        ((2, 32, 256), "bfloat16"),
        ((8, 512), "bfloat16"),
        ((16, 8, 384), "float32"),
        ((3, 7, 4096), "bfloat16"),        # model width, ragged row count
    ])
    def test_matches_reference(self, shape, dtype):
        rng = np.random.default_rng(shape[-1])
        xj, xt = _pair(rng, shape, dtype)
        wj, wt = _pair(rng, shape[-1:], dtype, shift=1.0)
        out = rn_ops.rmsnorm(xt, wt)
        ref = jax_rmsnorm_ref(xj, wj)
        assert out.dtype == xt.dtype and out.shape == xt.shape
        assert _err(ref, out) < 4e-6 * max(1.0, float(jnp.max(jnp.abs(
            ref.astype(jnp.float32)))))

    def test_matches_pallas_interpret(self):
        from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
        rng = np.random.default_rng(1)
        xj, xt = _pair(rng, (4, 64, 128))
        wj, wt = _pair(rng, (128,), shift=1.0)
        out = jax_rmsnorm(xj, wj, force="pallas_interpret")
        assert _err(out, rn_ops.rmsnorm(xt, wt)) < 4e-6

    def test_matches_model_rms_norm(self):
        from repro.models.common import rms_norm as jax_rms_norm
        from repro_torch.models.common import rms_norm
        rng = np.random.default_rng(2)
        xj, xt = _pair(rng, (2, 5, 8, 32), "bfloat16")
        wj, wt = _pair(rng, (32,), "float32", shift=1.0)
        # bf16 x with an fp32 w: w is rounded to bf16 first in both
        assert _err(jax_rms_norm(xj, wj), rms_norm(xt, wt)) < 4e-6 * 8


class TestFlashAttention:
    @pytest.mark.parametrize("b,sq,h,kvh,dh,causal,window", [
        (2, 256, 4, 2, 64, True, 0),      # GQA causal
        (1, 128, 4, 4, 32, True, 0),      # MHA
        (2, 256, 4, 1, 64, True, 64),     # MQA + sliding window
        (1, 512, 2, 2, 128, False, 0),    # bidirectional
        (1, 256, 8, 2, 128, True, 128),   # GQA + window
        (2, 100, 4, 2, 32, True, 0),      # ragged Sq
    ])
    def test_matches_reference(self, b, sq, h, kvh, dh, causal, window):
        rng = np.random.default_rng(b * 1000 + sq + h)
        qj, qt = _pair(rng, (b, sq, h, dh))
        kj, kt = _pair(rng, (b, sq, kvh, dh))
        vj, vt = _pair(rng, (b, sq, kvh, dh))
        out = fa_ops.attend(qt, kt, vt, causal=causal, window=window)
        ref = jax_attention_ref(qj, kj, vj, causal=causal, window=window)
        assert _err(ref, out) < 2e-5

    @pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                           ("bfloat16", 2e-2)])
    def test_dtypes(self, dtype, tol):
        rng = np.random.default_rng(0)
        qj, qt = _pair(rng, (1, 128, 2, 64), dtype)
        kj, kt = _pair(rng, (1, 128, 2, 64), dtype)
        vj, vt = _pair(rng, (1, 128, 2, 64), dtype)
        out = fa_ops.attend(qt, kt, vt)
        assert out.dtype == qt.dtype
        assert _err(jax_attention_ref(qj, kj, vj), out) < tol

    def test_q_offset(self):
        """Prefill continuation: queries start at global position 64."""
        rng = np.random.default_rng(3)
        qj, qt = _pair(rng, (1, 64, 4, 32))
        kj, kt = _pair(rng, (1, 128, 2, 32))
        vj, vt = _pair(rng, (1, 128, 2, 32))
        out = fa_ops.attend(qt, kt, vt, q_offset=64, window=48)
        ref = jax_attention_ref(qj, kj, vj, q_offset=64, window=48)
        assert _err(ref, out) < 2e-5

    def test_matches_pallas_interpret(self):
        from repro.kernels.flash_attention.kernel import flash_attention
        rng = np.random.default_rng(4)
        qj, qt = _pair(rng, (1, 128, 4, 32))
        kj, kt = _pair(rng, (1, 128, 2, 32))
        vj, vt = _pair(rng, (1, 128, 2, 32))
        out = flash_attention(qj, kj, vj, causal=True, block_q=128,
                              block_k=128, interpret=True)
        assert _err(out, fa_ops.attend(qt, kt, vt)) < 2e-5

    @pytest.mark.parametrize("q_chunk,window", [(64, 0), (64, 32), (256, 0)])
    def test_chunked_attention_matches_reference_model(self, q_chunk,
                                                       window):
        rng = np.random.default_rng(q_chunk + window)
        qj, qt = _pair(rng, (2, 256, 4, 32))
        kj, kt = _pair(rng, (2, 256, 2, 32))
        vj, vt = _pair(rng, (2, 256, 2, 32))
        ref = jax_attention.chunked_attention(qj, kj, vj, q_chunk=q_chunk,
                                              window=window)
        out = torch_attention.chunked_attention(qt, kt, vt, q_chunk=q_chunk,
                                                window=window)
        assert _err(ref, out) < 2e-5
        # and the kernel's plain version computes the same function
        assert _err(ref, fa_ops.attend(qt, kt, vt, window=window)) < 2e-5


class TestFlashDecode:
    @pytest.mark.parametrize("b,h,kvh,dh,L,clen,win", [
        (2, 4, 2, 64, 256, 100, 0),     # GQA, partial cache
        (1, 8, 1, 32, 128, 128, 0),     # MQA, full cache
        (2, 4, 4, 64, 256, 200, 64),    # MHA + sliding window
        (1, 2, 2, 128, 512, 37, 0),     # short cache in a long buffer
        (2, 32, 8, 128, 64, 1, 0),      # qwen3 heads, first position
    ])
    def test_matches_reference(self, b, h, kvh, dh, L, clen, win):
        rng = np.random.default_rng(L + clen)
        qj, qt = _pair(rng, (b, h, dh))
        kj, kt = _pair(rng, (b, L, kvh, dh))
        vj, vt = _pair(rng, (b, L, kvh, dh))
        out = fd_ops.decode_attend(qt, kt, vt,
                                   torch.tensor(clen, dtype=torch.int32),
                                   window=win)
        ref = jax_decode_ref(qj, kj, vj, jnp.int32(clen), window=win)
        assert _err(ref, out) < 2e-5

    @pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                           ("bfloat16", 3e-2)])
    def test_dtypes(self, dtype, tol):
        rng = np.random.default_rng(0)
        qj, qt = _pair(rng, (1, 4, 64), dtype)
        kj, kt = _pair(rng, (1, 128, 2, 64), dtype)
        vj, vt = _pair(rng, (1, 128, 2, 64), dtype)
        out = fd_ops.decode_attend(qt, kt, vt,
                                   torch.tensor(90, dtype=torch.int32))
        assert out.dtype == qt.dtype
        assert _err(jax_decode_ref(qj, kj, vj, jnp.int32(90)), out) < tol

    @pytest.mark.parametrize("ring,window,clen", [(False, 0, 40),
                                                  (False, 16, 40),
                                                  (True, 64, 100)])
    def test_decode_attention_matches_reference_model(self, ring, window,
                                                      clen):
        rng = np.random.default_rng(7)
        qj, qt = _pair(rng, (2, 1, 4, 32))
        kj, kt = _pair(rng, (2, 64, 2, 32))
        vj, vt = _pair(rng, (2, 64, 2, 32))
        ref = jax_attention.decode_attention(qj, kj, vj, jnp.int32(clen),
                                             window=window, ring=ring)
        cl = torch.tensor(clen, dtype=torch.int32)
        out = torch_attention.decode_attention(qt, kt, vt, cl,
                                               window=window, ring=ring)
        assert _err(ref, out) < 2e-5
        # the model's kernel call: a ring (window >= L) decodes as window 0
        got = fd_ops.decode_attend(qt[:, 0], kt, vt, cl,
                                   window=0 if ring else window)
        assert _err(ref[:, 0], got) < 2e-5

    @pytest.mark.parametrize("window", [0, 24, 40])
    @pytest.mark.parametrize("clen", [1, 10, 24, 37, 70])
    def test_ring_matches_reference_model(self, clen, window):
        """RecurrentGemma's decode: MQA with a group of 10 query heads over
        a ring cache of L = 24 slots, before (cache_len <= L) and after it
        wraps.  The model keeps a ring only when its window is at least L
        (24 = L, 40 > L; 0 is no window) and then calls the kernel with
        window 0, whose linear mask keeps the slots below min(cache_len, L):
        the reference's age mask, slot for slot."""
        rng = np.random.default_rng(clen * 31 + window)
        qj, qt = _pair(rng, (2, 1, 10, 32))
        kj, kt = _pair(rng, (2, 24, 1, 32))
        vj, vt = _pair(rng, (2, 24, 1, 32))
        ref = jax_attention.decode_attention(qj, kj, vj, jnp.int32(clen),
                                             window=window, ring=True)
        cl = torch.tensor(clen, dtype=torch.int32)
        got = fd_ops.decode_attend(qt[:, 0], kt, vt, cl, window=0)
        assert got.shape == (2, 10, 32)
        assert _err(ref[:, 0], got) < 2e-5

    def test_matches_pallas_interpret(self):
        from repro.kernels.flash_decode.kernel import flash_decode
        rng = np.random.default_rng(5)
        qj, qt = _pair(rng, (1, 8, 32))
        kj, kt = _pair(rng, (1, 128, 2, 32))
        vj, vt = _pair(rng, (1, 128, 2, 32))
        out = flash_decode(qj, kj, vj, jnp.int32(77), block_k=128,
                           interpret=True)
        got = fd_ops.decode_attend(qt, kt, vt,
                                   torch.tensor(77, dtype=torch.int32))
        assert _err(out, got) < 2e-5


class TestWrappers:
    """The CUDA branch of a wrapper launches its kernel or raises: it never
    falls back to the plain version."""

    @pytest.fixture
    def no_toolkit(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(build, "_libs", {})
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")

    def _calls(self):
        x = torch.ones(2, 8)
        q = torch.ones(1, 4, 2, 8)
        kv = torch.ones(1, 4, 1, 8)
        cl = torch.tensor(3, dtype=torch.int32)
        return {
            "rmsnorm": lambda: rn_ops._launch(x, torch.ones(8), 1e-6),
            "flash_attention": lambda: fa_ops._launch(q, kv, kv, True, 0, 0),
            "flash_decode": lambda: fd_ops._launch(q[:, 0], kv, kv, cl, 0),
            "flash_decode_partial": lambda: fd_ops._launch(
                q[:, 0], kv, kv, cl, 0, 4, 8, torch.empty(1, 2)),
            "rglru": lambda: rg_ops._launch(x[None], x[None], None),
            "rglru_bwd": lambda: rg_ops._launch_bwd(x[None], x[None],
                                                    x[None], None),
        }

    @pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                      "flash_decode", "flash_decode_partial",
                                      "rglru", "rglru_bwd"])
    def test_launch_without_toolkit_raises(self, no_toolkit, name):
        mod, attr = {"rmsnorm": (rn_ops, "launches"),
                     "flash_attention": (fa_ops, "launches"),
                     "flash_decode": (fd_ops, "launches"),
                     "flash_decode_partial": (fd_ops, "partial_launches"),
                     "rglru": (rg_ops, "launches"),
                     "rglru_bwd": (rg_ops, "bwd_launches")}[name]
        before = getattr(mod, attr)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            self._calls()[name]()
        assert getattr(mod, attr) == before

    def test_library_path_follows_every_header(self, monkeypatch, tmp_path):
        """A library is named by its source, every ``csrc/*.cuh`` and the
        flags, so an edit to any shared header rebuilds it."""
        for name, text in (("k.cu", "src"), ("common.cuh", "a"),
                           ("mma.cuh", "b")):
            (tmp_path / name).write_text(text)
        monkeypatch.setattr(build, "CSRC", tmp_path)
        first = build._library_path("k")
        assert build._library_path("k") == first
        (tmp_path / "mma.cuh").write_text("b2")
        second = build._library_path("k")
        assert second != first
        (tmp_path / "new.cuh").write_text("")
        assert build._library_path("k") not in (first, second)

    def test_signatures_cover_every_source(self):
        """Each library's entry points get their ctypes signature once, at
        load, from one table."""
        assert set(build.SIGNATURES) == set(build.SOURCES)
        assert all(name.startswith("repro_") for fns in
                   build.SIGNATURES.values() for name in fns)

    def test_cpu_calls_do_not_count(self):
        mods = (rn_ops, fa_ops, fd_ops, rg_ops)
        before = [m.launches for m in mods]
        rn_ops.rmsnorm(torch.ones(2, 8), torch.ones(8))
        fa_ops.attend(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 1, 8),
                      torch.ones(1, 4, 1, 8))
        fd_ops.decode_attend(torch.ones(1, 2, 8), torch.ones(1, 4, 1, 8),
                             torch.ones(1, 4, 1, 8),
                             torch.tensor(2, dtype=torch.int32))
        partial = fd_ops.partial_launches
        fd_ops.decode_attend_partial(
            torch.ones(1, 2, 8), torch.ones(1, 4, 1, 8),
            torch.ones(1, 4, 1, 8), torch.tensor(6, dtype=torch.int32),
            kv_offset=4, lmax=8)
        rg_ops.rglru_scan(torch.ones(1, 4, 8), torch.ones(1, 4, 8))
        assert [m.launches for m in mods] == before
        assert fd_ops.partial_launches == partial

    def test_entry_point_asks_for_the_card(self, monkeypatch):
        from repro_torch.launch import serve as launch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.resolve_device("cuda")
        assert launch.resolve_device("cpu").type == "cpu"

    @pytest.mark.parametrize("call,exc", [
        (lambda: rn_ops.rmsnorm(torch.ones(2, 8), torch.ones(4)), ValueError),
        (lambda: fa_ops.attend(torch.ones(1, 4, 3, 8), torch.ones(1, 4, 2, 8),
                               torch.ones(1, 4, 2, 8)), ValueError),
        (lambda: fd_ops.decode_attend(torch.ones(1, 2, 8),
                                      torch.ones(1, 4, 1, 8),
                                      torch.ones(1, 4, 1, 8), 3), TypeError),
    ])
    def test_bad_arguments_raise(self, call, exc):
        with pytest.raises(exc):
            call()
