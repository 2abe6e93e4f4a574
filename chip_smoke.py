#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase catches its own:

1. build   -- compile every CUDA source of the port (one nvcc each, in
              parallel) and print the build time;
2. kernels -- each kernel against its plain PyTorch version on the card at
              the serve paths' shapes, prefill and decode (bf16 attention
              and norms, fp32 RG-LRU), and at the other inputs each
              wrapper takes: max abs error beside its tolerance, median
              time (CUDA events) beside its bound, the plain version's time
              and, where one PyTorch call computes the same function, that
              call's time; RMSNorm's prefill shapes also cold (inputs
              rotated through more than the L2 cache), and once the launch
              floor (an 8-element add); then the registers and spills of
              every RMSNorm and attention kernel instance launched.  Then
              the gradient check: backward through each of the four ops at
              the serve paths' prefill shapes (and RG-LRU's decode step)
              against backward through its plain version on the card, at
              the forward's tolerance; each op's forward must launch its
              kernel once and its backward (plain formulas) none;
3. serve   -- for each served architecture (Qwen3-8B, then
              RecurrentGemma-2B), at its published width and depth, random
              weights from a seed, cast to bf16 once: 8 requests, prompt
              128, 32 new tokens, timed by the serve entry point.  Then one
              more ``generate`` of the same requests, with the launch
              counters zeroed just before and read just after: they must
              equal the counts the architecture's layers imply (every norm
              through the RMSNorm kernel, prefill attention through the
              flash-attention kernel, decode attention through the
              flash-decode kernel, every recurrence through the RG-LRU
              kernel).  The first decode step's logits are held against the
              same step with the plain versions, and torch.profiler shows
              where one prefill's and four decode steps' device time goes,
              with the device's idle share.  Each model is freed before the
              next is built;
4. train   -- for each of the paper's applications (ResNet-18, GNMT, the
              DDP microbenchmark's MLP) at the repo's paper configs' sizes,
              through ``repro_torch.launch.paper``: 10 DDP steps in fp32
              (TF32 off) on a one-rank NCCL group, the whole global batch on
              the card.  Every loss must be finite and ResNet-18's last
              below its first (class-conditioned data); the first step's
              updated parameters are held against the same step run by the
              port on the CPU; the all-reduces of one live step are counted
              by the interceptor.  Median step ms after the warm-up step,
              samples/s and peak memory are printed.  One more step of
              each is profiled under torch.profiler (CPU and CUDA, shapes
              recorded) and its Chrome trace written under ``build/`` for
              phase 7.  The group is destroyed at the end of the phase;
5. monitor -- for each architecture, the two-phase prefill/decode capture at
              full width on a fake 4x2 mesh, under FakeTensorMode on
              ``cuda``; its per-phase collective calls must equal a pinned
              table, and the report is saved, reloaded and compared.  Then
              each paper application's one-step capture at the same sizes
              on a fake 8-way ``cuda`` data mesh: its per-kind calls and
              payload bytes must equal a pinned table, its all-reduces the
              live step's count, and its report is saved, reloaded and
              compared.  Last, a ``batch_isend_irecv`` ring (7 steps of
              one (B*S, 4096) bf16 block) captured on a fake 8-way
              ``cuda`` mesh: its traced and recorded per-kind tables must
              equal a pinned table, one SendRecv a step;
6. scale   -- each architecture's full-width capture of phase 5 projected
              onto fleets with ``repro_torch.scale.scale_curve``: Qwen3-8B
              at 256 and 1024 devices, RecurrentGemma-2B at 256.  Each
              point prints its ``scale_table`` row, nnz, the sparse
              matrix's build ms, the bottleneck link and its ms, and its
              wall seconds.  At every point the COO matrix must equal
              ``matrix_for_ops(..., sparse=False)`` entry for entry and
              its link projection the dense matrix's, and on the capture
              and every point the batched ``total_time_split`` must equal
              the per-op sum bitwise;
7. trace   -- each paper application's profiled step (phase 4) imported
              with ``repro_torch.core.trace.load_trace``, which must sniff
              the torch frontend: its all-reduces must be the live step's
              count, their payload bytes in order those of the
              application's phase-5 capture, and ``compare`` against that
              capture must match every measured op with a finite relative
              error; the compare table and the measured ms per kind are
              printed (one rank of NCCL runs no kernel: those ms are the
              calls' host spans, a placeholder until a multi-rank run).  Then every phase-5 capture is linted: its
              ``lint_table``, its findings as rule -> count held to a pinned
              table, and the same findings after ``save(include_lint=True)``
              and a reload.

Then one JSON line with every kernel's numbers and each phase's seconds,
the card's name and power limit as nvidia-smi prints them, and, last, the
device line.  The script
needs ``src/repro_torch`` beside it and a CUDA device, and imports nothing of
JAX.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, bf16 tensor FLOP/s and
# fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

ARCHS = ("qwen3_8b", "recurrentgemma_2b")
BATCH, PROMPT_LEN, NEW_TOKENS = 8, 128, 32
PAPER_APPS = ("resnet", "gnmt", "paper")
TRAIN_STEPS = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(fn, *, iters: int = 20, reps: int = 5) -> float:
    """Median per-call device time in ms.  A sleep kernel queued first lets
    the host enqueue all ``iters`` calls before the device reaches them, so
    the events bracket back-to-back device work, not launch gaps."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float,
             peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# RMSNorm's cases and timings (also timed for another source tree by
# tools/rmsnorm_bench.py)
# ---------------------------------------------------------------------------
COLD_BYTES = 64 * 2**20   # more than the H100's 50 MB L2 cache


def rmsnorm_cases() -> list:
    """(case, shape, dtype, kind, storage offset in elements).  Kind
    "prefill" and "decode": the serve paths' rows in bf16 -- Qwen3-8B's
    model-width rows and the qk-norm rows of its 32 query and 8 kv heads,
    RecurrentGemma-2B's rows; prefill cases are timed cold too.  Kind
    "other": f16 and fp32 at Qwen's prefill rows; widths the kernels take
    at run time (lanes at 64; block at 384, at 2000 with four rows a CTA,
    at 16384 with four vectors a thread); and inputs only the scalar kernel
    takes: a contiguous view one element into its storage (not 16-byte
    aligned) and two widths whose rows are not a multiple of 16 bytes."""
    import torch

    bf16, rows = torch.bfloat16, BATCH * PROMPT_LEN
    return [
        ("rows(B*S,4096)", (rows, 4096), bf16, "prefill", 0),
        ("qk(B,S,32,128)", (BATCH, PROMPT_LEN, 32, 128), bf16, "prefill", 0),
        ("qk(B,S,8,128)", (BATCH, PROMPT_LEN, 8, 128), bf16, "prefill", 0),
        ("rows(B*S,2560)", (rows, 2560), bf16, "prefill", 0),
        ("decode rows(B,4096)", (BATCH, 4096), bf16, "decode", 0),
        ("decode qk(B,1,32,128)", (BATCH, 1, 32, 128), bf16, "decode", 0),
        ("decode qk(B,1,8,128)", (BATCH, 1, 8, 128), bf16, "decode", 0),
        ("decode rows(B,2560)", (BATCH, 2560), bf16, "decode", 0),
        ("f16 rows(B*S,4096)", (rows, 4096), torch.float16, "other", 0),
        ("fp32 rows(B*S,4096)", (rows, 4096), torch.float32, "other", 0),
        ("width 64 (8,64)", (8, 64), bf16, "other", 0),
        ("width 384 (8,384)", (8, 384), bf16, "other", 0),
        ("width 2000 (4096,2000)", (4096, 2000), bf16, "other", 0),
        ("width 16384 (8,16384)", (8, 16384), bf16, "other", 0),
        ("misaligned decode rows(B,4096)", (BATCH, 4096), bf16, "other", 1),
        ("odd width (8,100)", (8, 100), bf16, "other", 0),
        ("odd width (B*S,4095)", (rows, 4095), bf16, "other", 0),
    ]


def rmsnorm_inputs(shape, dtype, offset, gen):
    """x of ``shape`` (a contiguous view ``offset`` elements into its
    storage) and w near 1, both in ``dtype``, on the card."""
    import torch

    dev = gen.device
    store = torch.randn(offset + math.prod(shape), generator=gen,
                        device=dev).to(dtype)
    w = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device=dev))
    return store[offset:].view(shape), w.to(dtype)


def rmsnorm_times(x, w, *, cold: bool) -> dict:
    """The wrapper's, the plain version's and ``F.rms_norm``'s median
    times on (x, w), and the bound.  ``cold``: also the wrapper's and
    ``F.rms_norm``'s times over copies of x that together exceed the L2
    cache, a different one each launch."""
    import itertools

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    d = x.shape[-1]
    b, by = bound_ms(2 * x.numel() * x.element_size() + w.numel()
                     * w.element_size(), 4 * x.numel(), FP32_FLOPS)
    t = dict(ms=time_ms(lambda: rn_ops.rmsnorm(x, w, 1e-6)),
             plain_ms=time_ms(lambda: rmsnorm_ref(x, w, 1e-6)),
             library_ms=time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
             bound_ms=b, bound_by=by)
    if cold:
        n = max(2, -(-COLD_BYTES // (x.numel() * x.element_size())))
        xs = [x.clone() for _ in range(n)]
        nxt = itertools.cycle(xs).__next__
        t["cold_ms"] = time_ms(lambda: rn_ops.rmsnorm(nxt(), w, 1e-6))
        t["library_cold_ms"] = time_ms(
            lambda: F.rms_norm(nxt(), (d,), w, 1e-6))
        del xs
    return t


def launch_floor_ms() -> float:
    """Median time of an 8-element in-place add on the card: what one
    launch of the least work costs back to back (a library op, timed for
    reference only)."""
    import torch

    z = torch.zeros(8, device="cuda")
    return time_ms(lambda: z.add_(1.0))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import decode_ref
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    results: dict = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    def record(name, case, err, tol, ms, plain, lib, bound, by):
        ok = err <= tol
        log(f"[kernels] {name} {case}: max_abs_err {err:.3e} (tol {tol:g}) "
            f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms | bound "
            f"{bound:.4g} ms ({by}) | plain {plain:.4f} ms | library "
            + (f"{lib:.4f} ms" if lib is not None else "n/a"))
        if not ok:
            fail(f"{name} {case}: max abs err {err} > tol {tol}")
        return ok

    # -- RMSNorm: every case of rmsnorm_cases(), each against the plain
    # version on the same inputs, with its launch plan; then the launch floor
    launched = {"rmsnorm": set(), "flash_attention": set(),
                "flash_decode": set()}
    errs, main = [], None
    for case, shape, dtype, kind, offset in rmsnorm_cases():
        prefill = kind == "prefill"
        x, w = rmsnorm_inputs(shape, dtype, offset, gen)
        out = rn_ops.rmsnorm(x, w, 1e-6)
        torch.cuda.synchronize()
        plan = rn_ops.plan_for(x, w)
        launched["rmsnorm"].add((dtype, shape[-1], plan))
        ref = rmsnorm_ref(x, w, 1e-6).float()
        err = (out.float() - ref).abs().max().item()
        # bf16/f16: one ulp at |y| ~ 2-4, since the fp32 sum order may flip a
        # rounding; fp32: tests/test_torch_kernels.py's RMSNorm tolerance
        tol = (4e-6 * max(1.0, ref.abs().max().item())
               if dtype == torch.float32 else 2e-2)
        t = rmsnorm_times(x, w, cold=prefill)
        log(f"[kernels] rmsnorm {case}: plan {plan.variant} {plan.threads} "
            f"threads x {plan.vpt} vectors, {plan.rows_per_cta} rows a CTA"
            + (f" | cold: kernel {t['cold_ms']:.4f} ms, library "
               f"{t['library_cold_ms']:.4f} ms" if prefill else ""))
        record("rmsnorm", case, err, tol, t["ms"], t["plain_ms"],
               t["library_ms"], t["bound_ms"], t["bound_by"])
        errs.append(err)
        if main is None:
            main = {k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")}
    results["rmsnorm"] = dict(main, max_abs_err=max(errs))
    log(f"[kernels] launch floor: {launch_floor_ms():.4f} ms, an 8-element "
        "in-place add (a library op, timed for reference only)")

    # -- prefill attention: Qwen3-8B's causal main shape, a ragged Sq, a
    # window, a chunk at q_offset 128, rows with no visible key (their
    # outputs must be exactly 0, as from the Pallas kernel: the plain version
    # gives the mean of v there, so these are held against zeros), dh 64;
    # RecurrentGemma-2B's MQA at dh 256, causal and windowed; all bf16 on the
    # tensor-core kernel, then one f16 case on the same kernel and one fp32
    # case on the CUDA-core kernel
    errs, main = [], None
    f32 = torch.float32
    for case, sq, skv, h, kvh, dh, window, q_offset, dtype, tol in (
            ("causal B8 S128", PROMPT_LEN, PROMPT_LEN, 32, 8, 128, 0, 0,
             bf16, 2e-2),
            ("ragged S100", 100, 100, 32, 8, 128, 0, 0, bf16, 2e-2),
            ("window48 S128", PROMPT_LEN, PROMPT_LEN, 32, 8, 128, 48, 0,
             bf16, 2e-2),
            ("q_offset128 Sq64 Skv192", 64, 192, 32, 8, 128, 0, 128, bf16,
             2e-2),
            ("fully masked Sq64 Skv64 q_offset200 window100", 64, 64, 32, 8,
             128, 100, 200, bf16, 0.0),
            ("dh64 S128", PROMPT_LEN, PROMPT_LEN, 32, 8, 64, 0, 0, bf16,
             2e-2),
            ("mqa dh256 causal", PROMPT_LEN, PROMPT_LEN, 10, 1, 256, 0, 0,
             bf16, 2e-2),
            ("mqa dh256 window100", PROMPT_LEN, PROMPT_LEN, 10, 1, 256, 100,
             0, bf16, 2e-2),
            ("f16 causal B8 S128", PROMPT_LEN, PROMPT_LEN, 32, 8, 128, 0, 0,
             torch.float16, 2e-2),
            # tests/test_kernels.py fp32 tolerance
            ("fp32 causal B8 S128", PROMPT_LEN, PROMPT_LEN, 32, 8, 128, 0, 0,
             f32, 2e-5)):
        q = randn(BATCH, sq, h, dh).to(dtype)
        k = randn(BATCH, skv, kvh, dh).to(dtype)
        v = randn(BATCH, skv, kvh, dh).to(dtype)

        def kernel():
            return fa_ops.attend(q, k, v, causal=True, window=window,
                                 q_offset=q_offset)

        def plain():
            return attention_ref(q, k, v, causal=True, window=window,
                                 q_offset=q_offset)

        out = kernel()
        torch.cuda.synchronize()
        launched["flash_attention"].add((dtype, dh))
        qpos = q_offset + torch.arange(sq, device=dev)
        kpos = torch.arange(skv, device=dev)
        mask = kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        if bool(mask.any(-1).all()):
            err = (out.float() - plain().float()).abs().max().item()
        else:   # no row sees a key: every output must be exactly 0
            err = out.float().abs().max().item()
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        plain_causal = not window and not q_offset and sq == skv
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=None if plain_causal else mask,
            is_causal=plain_causal, enable_gqa=True))
        pairs = int(mask.sum().item())
        size = q.element_size()
        b, by = bound_ms(size * (2 * q.numel() + k.numel() + v.numel()),
                         4 * BATCH * h * pairs * dh,
                         FP32_FLOPS if dtype == f32 else BF16_FLOPS)
        record("flash_attention", case, err, tol, ms, plain_ms, lib, b, by)
        errs.append(err)
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b,
                        bound_by=by)
    results["flash_attention"] = dict(main, max_abs_err=max(errs))

    # -- flash decode.  The serve paths decode a cache of PROMPT_LEN +
    # NEW_TOKENS = 160 slots from cache_len 129 (the first step) on:
    # Qwen3-8B's linear cache, 32 query heads over 8 kv heads of 128 (the
    # first case, the kernel's main row in the JSON line), and
    # RecurrentGemma-2B's ring, 10 query heads of 256 over one kv head, at
    # its first step and its last slot (the model decodes a ring with window
    # 0, its window being at least L, so every ring case calls the kernel as
    # the model does).  Then Qwen's heads on a 256-slot cache at cache_len
    # 1, 16, 17 (most splits empty), 129, 256, and 129 with a window of 48
    # (the window starts inside a chunk); the full 2048-slot ring of a long
    # request, before (129) and after (2048 + 100: all live) it wraps; and
    # the other inputs the wrapper accepts, each on its own path through the
    # split kernel: fp32 q and caches at dh 256 (4-wide vectors, rows of 64
    # vectors: one (head, key) pair a warp), fp32 q over bf16 caches, f16,
    # dh 80 (not dividing the 256 threads: flat-index output owners) and dh
    # 100 (not a multiple of 8: element-wise loads).
    errs, main = [], None
    f16, slots = torch.float16, PROMPT_LEN + NEW_TOKENS
    cases = [(f"cache_len 129 L{slots}", 129, 32, 8, 128, slots, 0, bf16,
              bf16)]
    cases += [(f"ring cache_len {n} L{slots}", n, 10, 1, 256, slots, 0, bf16,
               bf16) for n in (129, slots)]
    cases += [(f"cache_len {n} L256", n, 32, 8, 128, 256, 0, bf16, bf16)
              for n in (129, 1, 16, 17, 256)]
    cases.append(("cache_len 129 window 48 L256", 129, 32, 8, 128, 256, 48,
                  bf16, bf16))
    cases += [(f"ring cache_len {n} L2048", n, 10, 1, 256, 2048, 0, bf16,
               bf16) for n in (129, 2048 + 100)]
    cases += [
        (f"fp32 q/cache dh256 G10 L{slots}", 129, 10, 1, 256, slots, 0, f32,
         f32),
        (f"fp32 q bf16 cache L{slots}", 129, 32, 8, 128, slots, 0, f32, bf16),
        (f"f16 q/cache L{slots}", 129, 32, 8, 128, slots, 0, f16, f16),
        (f"dh80 G4 L{slots}", 129, 16, 4, 80, slots, 0, bf16, bf16),
        (f"dh100 G4 L{slots}", 129, 16, 4, 100, slots, 0, bf16, bf16)]
    for case, clen, h, kvh, dh, lmax, window, qdt, kvdt in cases:
        kc = randn(BATCH, lmax, kvh, dh).to(kvdt)
        vc = randn(BATCH, lmax, kvh, dh).to(kvdt)
        q = randn(BATCH, h, dh).to(qdt)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)

        def kernel():
            return fd_ops.decode_attend(q, kc, vc, cl, window=window)

        out = kernel()
        torch.cuda.synchronize()
        launched["flash_decode"].add((qdt, kvdt))
        ref = decode_ref(q, kc, vc, cl, window=window).float()
        err = (out.float() - ref).abs().max().item()
        # fp32 sums in another order, then one rounding of the output: in a
        # 16-bit q dtype at most one ulp of the largest output (2^-7 *
        # max|ref| in bf16, 2^-10 in f16).  Errors on an H100 80GB: 0
        # (cache_len 1, out = v), 9.8e-4 (bf16, 129) and 2.4e-4 (bf16,
        # 2148); each case prints its tolerance beside them.  An fp32 output
        # is held to the fp32 tolerance of tests/test_kernels.py
        tol = (2e-5 if qdt == f32
               else torch.finfo(qdt).eps * ref.abs().max().item())
        ms = time_ms(kernel)
        plain = time_ms(lambda: decode_ref(q, kc, vc, cl, window=window))
        # the live slots of either layout: [cache_len - window if window,
        # min(cache_len, L))
        hi = min(clen, lmax)
        lo = max(0, clen - window) if window else 0
        kt = kc[:, lo:hi].transpose(1, 2)
        vt = vc[:, lo:hi].transpose(1, 2)
        lib = None   # SDPA takes one dtype for q, k and v
        if qdt == kvdt:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, enable_gqa=True))
        live = hi - lo
        b, by = bound_ms(
            2 * BATCH * live * kvh * dh * kc.element_size()
            + 2 * q.numel() * q.element_size(), 4 * BATCH * h * live * dh,
            FP32_FLOPS if qdt == f32 else BF16_FLOPS)
        log(f"[kernels] flash_decode {case}: nsplit "
            f"{fd_ops.splits_for(q, kc)} ({BATCH * kvh} (b, kv head) groups)")
        record("flash_decode", case, err, tol, ms, plain, lib, b, by)
        errs.append(err)
        if main is None:
            main = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                        bound_by=by)
    results["flash_decode"] = dict(main, max_abs_err=max(errs))
    check_kernel_attrs(launched)

    # -- RG-LRU: RecurrentGemma-2B's prefill (8,128,2560) from a zero state
    # and its decode step (8,1,2560) carrying h0, fp32.  No single PyTorch
    # call computes a linear recurrence, so there is no library time
    tol = 1e-4   # the same fp32 recurrence; only FMA contraction may differ
    errs, main = [], None
    d_rnn = 2560
    for case, s_len, with_h0 in (("prefill (8,128,2560)", PROMPT_LEN, False),
                                 ("decode (8,1,2560) h0", 1, True)):
        x = torch.randn(BATCH, s_len, d_rnn, generator=gen, device=dev)
        la = -F.softplus(torch.randn(BATCH, s_len, d_rnn, generator=gen,
                                     device=dev))
        h0 = (torch.randn(BATCH, d_rnn, generator=gen, device=dev)
              if with_h0 else None)
        out = rg_ops.rglru_scan(x, la, h0)
        torch.cuda.synchronize()
        err = (out - rglru_ref(x, la, h0)).abs().max().item()
        ms = time_ms(lambda: rg_ops.rglru_scan(x, la, h0))
        plain = time_ms(lambda: rglru_ref(x, la, h0))
        nbytes = 3 * x.numel() * 4 + (h0.numel() * 4 if with_h0 else 0)
        b, by = bound_ms(nbytes, 3 * x.numel(), FP32_FLOPS)
        record("rglru", case, err, tol, ms, plain, None, b, by)
        errs.append(err)
        if main is None:
            main = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b,
                        bound_by=by)
    results["rglru"] = dict(main, max_abs_err=max(errs))
    return results


def check_kernel_grads() -> dict:
    """Phase 2's gradient check: each op's backward (its autograd formula
    over the plain version) against autograd through the plain version
    itself, both on the card, at the serve paths' shapes and the forward's
    tolerance.  The op's forward must launch its kernel once, its backward
    none.  Returns each kernel's max abs gradient error."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import decode_ref
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, slots = torch.bfloat16, PROMPT_LEN + NEW_TOKENS

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    cl = torch.tensor(129, dtype=torch.int32, device=dev)
    rows = BATCH * PROMPT_LEN
    d_rnn = 2560
    # (kernel, case, op, plain, inputs, tol): bf16 at the forward's 2e-2
    # (flash decode: one bf16 ulp of the largest gradient), RG-LRU fp32 at
    # 1e-4
    cases = [
        ("rmsnorm", "rows(B*S,4096)", rn_ops, lambda x, w: rn_ops.rmsnorm(
            x, w, 1e-6), lambda x, w: rmsnorm_ref(x, w, 1e-6),
         [randn(rows, 4096), 1.0 + 0.1 * randn(4096)], 2e-2),
        ("flash_attention", "causal B8 S128", fa_ops,
         lambda q, k, v: fa_ops.attend(q, k, v, causal=True),
         lambda q, k, v: attention_ref(q, k, v, causal=True),
         [randn(BATCH, PROMPT_LEN, 32, 128), randn(BATCH, PROMPT_LEN, 8, 128),
          randn(BATCH, PROMPT_LEN, 8, 128)], 2e-2),
        ("flash_decode", f"cache_len 129 L{slots}", fd_ops,
         lambda q, k, v: fd_ops.decode_attend(q, k, v, cl),
         lambda q, k, v: decode_ref(q, k, v, cl),
         [randn(BATCH, 32, 128), randn(BATCH, slots, 8, 128),
          randn(BATCH, slots, 8, 128)], None),
        ("rglru", "prefill (8,128,2560)", rg_ops, rg_ops.rglru_scan,
         rglru_ref, [randn(BATCH, PROMPT_LEN, d_rnn, dtype=torch.float32),
                     -F.softplus(randn(BATCH, PROMPT_LEN, d_rnn,
                                       dtype=torch.float32))], 1e-4),
        ("rglru", "decode (8,1,2560) h0", rg_ops, rg_ops.rglru_scan,
         rglru_ref, [randn(BATCH, 1, d_rnn, dtype=torch.float32),
                     -F.softplus(randn(BATCH, 1, d_rnn, dtype=torch.float32)),
                     randn(BATCH, d_rnn, dtype=torch.float32)], 1e-4),
    ]

    def grads(fn, inputs, dy):
        ts = [t.detach().clone().requires_grad_() for t in inputs]
        fn(*ts).backward(dy)
        return [t.grad.float() for t in ts]

    errs: dict = {}
    for name, case, mod, op, plain, inputs, tol in cases:
        dy = torch.randn(op(*inputs).shape, generator=gen,
                         device=dev).to(inputs[0].dtype)
        before = mod.launches
        got = grads(op, inputs, dy)
        torch.cuda.synchronize()
        if mod.launches != before + 1:
            fail(f"{name} {case}: forward + backward launched the kernel "
                 f"{mod.launches - before} times, not once")
        want = grads(plain, inputs, dy)
        if tol is None:
            tol = torch.finfo(bf16).eps * max(w.abs().max().item()
                                              for w in want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        log(f"[grad] {name} {case}: max_abs_err {err:.3e} over "
            f"{len(got)} input gradients (tol {tol:g}) "
            f"{'ok' if finite and err <= tol else 'FAIL'}")
        if not (finite and err <= tol):
            fail(f"{name} {case}: gradient differs from the plain "
                 f"version's: {err} > {tol}")
        errs[name] = max(errs.get(name, 0.0), err)
    # the backwards ran on autograd's device thread, whose cuBLAS handle
    # keeps a workspace of its own (32 MiB on Hopper) for the life of the
    # process; free it, so that the serve phase's peak memory is what a
    # serving process holds
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return errs


def check_kernel_attrs(launched: dict) -> None:
    """Registers and local memory (spills) a thread of every kernel instance
    the kernel phase launched for RMSNorm and attention, as the CUDA
    runtime reports them: RMSNorm by (dtype, width, plan), flash attention
    by (dtype, head dim), flash decode's split kernel by (q dtype, cache
    dtype) and its combine by q dtype.  Any local memory fails the run."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import ops as rn_ops

    code, name_of = build.DTYPE_CODES, lambda dt: str(dt).split(".")[-1]
    out = (ctypes.c_int * 4)()
    rows = []
    for dtype, d, plan in sorted(launched["rmsnorm"], key=str):
        build.check("rmsnorm", build.library("rmsnorm").repro_rmsnorm_attrs(
            code[dtype], rn_ops.VARIANTS[plan.variant], d, plan.threads,
            plan.vpt, ctypes.addressof(out)))
        rows.append((f"rmsnorm {name_of(dtype)} d{d} {plan.variant} "
                     f"{plan.threads}x{plan.vpt}", out[0], out[1]))
    for dtype, dh in sorted(launched["flash_attention"], key=str):
        build.check("flash_attention", build.library(
            "flash_attention").repro_flash_attention_attrs(
                code[dtype], dh, ctypes.addressof(out)))
        rows.append((f"flash_attention {name_of(dtype)} dh{dh}", out[0],
                     out[1]))
    for qdt, kvdt in sorted(launched["flash_decode"], key=str):
        build.check("flash_decode", build.library(
            "flash_decode").repro_flash_decode_attrs(
                code[qdt], code[kvdt], ctypes.addressof(out)))
        rows.append((f"flash_decode split {name_of(qdt)}/{name_of(kvdt)}",
                     out[0], out[1]))
        rows.append((f"flash_decode combine {name_of(qdt)}", out[2], out[3]))
    for name, regs, local in dict.fromkeys(rows):
        log(f"[kernels] {name}: {regs} registers, {local} B local memory "
            "a thread")
        if local != 0:
            fail(f"{name} uses {local} B of local memory a thread (spills)")


def expected_launches(cfg, steps: int) -> dict:
    """Kernel launches of one prefill and ``steps`` decode steps: per
    prefill and per decode step two RMSNorms a layer (norm1, norm2), two
    more per attention layer with qk-norm, and the final norm; per prefill
    one flash attention an attention layer, per decode step one flash
    decode an attention layer; per prefill and per decode step one RG-LRU
    scan a recurrent layer (``cfg.block_kind`` names each layer's kind)."""
    n = cfg.n_layers
    n_attn = sum(cfg.block_kind(i) == "attn" for i in range(n))
    norms = 2 * n + 1 + (2 * n_attn if cfg.qk_norm else 0)
    return {"rmsnorm": (1 + steps) * norms, "flash_attention": n_attn,
            "flash_decode": steps * n_attn,
            "rglru": (1 + steps) * (n - n_attn)}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def run_serve(arch: str) -> tuple[dict, dict]:
    """Phase 3 for one architecture: the port's serve entry point at full
    width and depth, then the counted main-path run: one more ``generate``
    over the same prompts, with every launch count zeroed just before it
    and read just after.  (``launch.serve`` runs an untimed warm-up before
    its timed run, so counts taken around it would hold the warm-up's
    launches too.)  Returns the counted run's launch counts and the serve
    result."""
    from unittest import mock

    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import decode_ref
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.launch import serve as launch
    from repro_torch.parallel import Sharder
    from repro_torch.serve import generate

    cfg = launch.model_config(arch)
    res = launch.serve(cfg, batch=BATCH, prompt_len=PROMPT_LEN,
                       tokens=NEW_TOKENS, device="cuda")
    log(f"[serve] {cfg.name} d{cfg.d_model} {cfg.n_layers} layers, {BATCH} "
        f"requests x prompt {PROMPT_LEN} + {NEW_TOKENS} tokens: prefill "
        f"{res['prefill_ms']:.2f} ms | decode "
        f"{res['decode_ms_per_token']:.2f} ms/token | "
        f"{res['tokens_per_s']:.1f} tok/s | max memory "
        f"{res['max_memory_bytes'] / 2**30:.2f} GiB")

    model, params, shd = res["model"], res["params"], Sharder()
    mods = {"rmsnorm": rn_ops, "flash_attention": fa_ops,
            "flash_decode": fd_ops, "rglru": rg_ops}
    for m in mods.values():
        m.launches = 0
    toks = generate(model, params, res["prompts"], shd, steps=NEW_TOKENS,
                    max_len=PROMPT_LEN + NEW_TOKENS)
    torch.cuda.synchronize()
    counts = {name: m.launches for name, m in mods.items()}
    steps = NEW_TOKENS - 1
    expect = expected_launches(cfg, steps)
    log(f"[serve] {cfg.name} kernel launches of one prefill + {steps} decode "
        f"steps {counts} (expected {expect})")
    if counts != expect:
        fail(f"{cfg.name} launch counts {counts} != expected {expect}")
    for run, t in (("timed", res["tokens"]), ("counted", toks)):
        if tuple(t.shape) != (BATCH, NEW_TOKENS) or not bool(
                ((t >= 0) & (t < cfg.vocab_size)).all()):
            fail(f"bad generated tokens of the {run} run {tuple(t.shape)}")
    same = (toks == res["tokens"]).float().mean().item()
    log(f"[serve] sample tokens {toks[0, :12].tolist()}; share equal to the "
        f"timed run's tokens {same:.3f}")

    # first decode step: kernels against the plain versions on the card
    with torch.inference_mode():
        logits0, cache = model.prefill(params, {"tokens": res["prompts"]},
                                       shd, max_len=PROMPT_LEN + NEW_TOKENS)
        tok = logits0.float().argmax(-1)[:, None]
        plain_cache = _clone(cache)
        got, _ = model.decode_step(params, cache, {"tokens": tok}, shd)
        with mock.patch.object(rn_ops, "rmsnorm", rmsnorm_ref), \
                mock.patch.object(fd_ops, "decode_attend", decode_ref), \
                mock.patch.object(rg_ops, "rglru_scan", rglru_ref):
            want, _ = model.decode_step(params, plain_cache,
                                        {"tokens": tok}, shd)
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail("non-finite logits")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    # bf16 through every layer: each of the kernels' fp32 sums may flip a
    # bf16 rounding the plain version made the other way, and the flips
    # compound over depth; 5% of the largest logit bounds that drift
    tol = 0.05 * scale
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[serve] {cfg.name} first decode step logits vs plain versions: "
        f"max_abs_err {err:.4f} (tol {tol:.4f} = 5% of max |logit| "
        f"{scale:.2f}), argmax agreement {agree:.3f}")
    if not err <= tol:
        fail(f"decode logits differ from the plain versions: {err} > {tol}")
    return counts, res


def profile_window(name: str, fn) -> None:
    """``torch.profiler`` over one call of ``fn``: the ten device kernels
    with the most self time, then every kernel of the port's, and the
    device's idle share of the wall time (both under the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if not rows:
        log(f"[profile] {name}: no device time in the trace "
            "(device busy share not measured)")
        return
    log(f"[profile] {name}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    # the top ten, then the port's own kernels below them
    for e in rows[:10] + [e for e in rows[10:]
                          if any(k in e.key for k in KERNEL_META)]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d} calls  {e.key[:90]}")


def profile_serve(res, steps: int = 4) -> None:
    """Where the serve step's time goes: :func:`profile_window` over one
    prefill and over ``steps`` decode steps."""
    import torch

    from repro_torch.parallel import Sharder

    model, params, shd = res["model"], res["params"], Sharder()
    max_len = PROMPT_LEN + NEW_TOKENS

    with torch.inference_mode():
        state = {}

        def prefill():
            state["logits"], state["cache"] = model.prefill(
                params, {"tokens": res["prompts"]}, shd, max_len=max_len)

        def decode():
            tok = state["logits"].float().argmax(-1)[:, None]
            for _ in range(steps):
                logits, _ = model.decode_step(params, state["cache"],
                                              {"tokens": tok}, shd)
                tok = logits[:, -1].float().argmax(-1)[:, None]

        name = model.cfg.name
        profile_window(f"{name} prefill", prefill)
        profile_window(f"{name} decode x{steps}", decode)


# Each architecture's full-width capture: (phase, kind) -> calls on a fake
# 4x2 ``cuda`` mesh.  A ``cuda`` mesh's shard-to-shard redistribution is
# DTensor's own ``_dtensor.shard_dim_alltoall`` (a CPU mesh issues
# all-gather + chunk instead): an interceptor that misses it drops every
# all-to-all here.
MONITOR_CALLS = {
    "qwen3_8b": {
        ("prefill", "all-to-all"): 218, ("prefill", "all-gather"): 109,
        ("prefill", "reduce-scatter"): 181, ("prefill", "all-reduce"): 73,
        ("decode", "all-to-all"): 218, ("decode", "all-gather"): 109,
        ("decode", "reduce-scatter"): 145, ("decode", "all-reduce"): 73,
    },
    "recurrentgemma_2b": {
        ("prefill", "all-to-all"): 140, ("prefill", "all-gather"): 111,
        ("prefill", "reduce-scatter"): 89, ("prefill", "all-reduce"): 71,
        ("decode", "all-to-all"): 140, ("decode", "all-gather"): 103,
        ("decode", "reduce-scatter"): 105, ("decode", "all-reduce"): 71,
    },
}


def run_monitor(arch: str):
    """Phase 5 for one architecture: two-phase capture on a fake 4x2 mesh,
    its per-phase collective calls held to :data:`MONITOR_CALLS`, saved and
    reloaded.  Returns the report."""
    from repro_torch.launch import serve as launch

    cfg = launch.model_config(arch)
    t0 = time.perf_counter()
    rep = launch.monitor(cfg, mesh_shape=(4, 2), batch=BATCH,
                         prompt_len=PROMPT_LEN, tokens=NEW_TOKENS,
                         device="cuda")
    log(f"[monitor] {cfg.name} {cfg.n_layers}L on a fake 4x2 mesh: "
        f"{len(rep.compiled_ops)} collectives captured in "
        f"{time.perf_counter() - t0:.3f} s, "
        f"{sum(len(g.nodes) for g in rep._defuse_graphs)} ops recorded "
        "for the lint")
    log(rep.phase_table())
    log(rep.heatmap(phase="decode"))
    calls = {(ph, kind): row["calls"]
             for ph, summ in rep.phase_summaries().items()
             for kind, row in summ.items()}
    log(f"[monitor] {cfg.name} per-phase calls {calls}")
    if not any(kind == "all-to-all" for _, kind in calls):
        fail(f"{cfg.name}: no all-to-all recorded on a cuda mesh")
    if calls != MONITOR_CALLS[arch]:
        fail(f"{cfg.name} per-phase collective calls {calls} != expected "
             f"{MONITOR_CALLS[arch]}")
    save_and_reload(rep, arch)
    return rep


def save_and_reload(rep, name: str) -> None:
    """Save ``rep`` under ``build/``, load it back and hold its summary,
    phases and matrix to the original's."""
    from repro_torch.core import CommReport

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / f"chip_smoke_{name}_report.json"
    rep.save(str(path))
    back = CommReport.load(str(path))
    if back.compiled_summary != rep.compiled_summary \
            or back.view().summary != rep.compiled_summary \
            or back.phase_names() != rep.phase_names():
        fail(f"{name}: reloaded report's summary differs from the original")
    if not (back.matrix == rep.matrix).all():
        fail(f"{name}: reloaded report's matrix differs from the original")
    log(f"[monitor] report saved to {path.relative_to(ROOT)} and reloaded: "
        "summary and matrix equal")


# Each paper application's one-step capture at its paper config's sizes on a
# fake 8-way ``cuda`` data mesh (``launch.paper.monitor``): kind -> (calls,
# payload bytes).  The all-reduces are the 1 MiB gradient buckets (plus the
# loss average of ``make_ddp_train_step``); GNMT's all-gathers are its
# startup Broadcast (one per parameter, each gathering 8 copies) and the
# metrics gather of its one step loss
PAPER_MONITOR = {
    "resnet": {"all-reduce": (17, 45078564)},
    "gnmt": {"all-gather": (17, 211943456), "all-reduce": (15, 26492928)},
    "paper": {"all-reduce": (4, 2101252)},
}


def run_paper_monitor(name: str, live_allreduces: int):
    """Phase 5 for one paper application: its one-step capture, held to
    :data:`PAPER_MONITOR` and to the all-reduces one live step issued.
    Returns the report."""
    from repro_torch.launch import paper as launch

    t0 = time.perf_counter()
    rep = launch.monitor(launch.make_app(name), mesh_spec="8",
                         device="cuda")
    log(f"[monitor] {name} one step on a fake 8-way data mesh: "
        f"{len(rep.compiled_ops)} collectives captured in "
        f"{time.perf_counter() - t0:.3f} s, "
        f"{sum(len(g.nodes) for g in rep._defuse_graphs)} ops recorded "
        "for the lint")
    log(rep.usage_table())
    log(rep.heatmap())
    got = {kind: (row["calls"], row["payload_bytes"])
           for kind, row in rep.compiled_summary.items()}
    log(f"[monitor] {name} (calls, payload bytes) by kind {got}; a live step "
        f"issued {live_allreduces} all-reduces")
    if got != PAPER_MONITOR[name]:
        fail(f"{name} collectives {got} != expected {PAPER_MONITOR[name]}")
    if got["all-reduce"][0] != live_allreduces:
        fail(f"{name}: the capture records {got['all-reduce'][0]} "
             f"all-reduces, a live step issued {live_allreduces}")
    save_and_reload(rep, f"paper_{name}")
    return rep


# The ring of phase 5: kind -> (calls, payload bytes), traced and recorded.
# Seven steps, each a send of one (B*S, 4096) bf16 block to the next rank
# and a recv from the previous one: one SendRecv, a collective-permute over
# the whole ring
RING_STEPS = 7
RING_BLOCK = BATCH * PROMPT_LEN * 4096 * 2
RING_MONITOR = {
    "traced": {"SendRecv": (RING_STEPS, RING_STEPS * RING_BLOCK)},
    "compiled": {"collective-permute": (RING_STEPS,
                                        RING_STEPS * RING_BLOCK)},
}


def run_ring_monitor() -> None:
    """Phase 5's ring: :data:`RING_STEPS` ``batch_isend_irecv`` steps on a
    fake 8-way ``cuda`` mesh, held to :data:`RING_MONITOR`; each recorded
    op's pairs must be the whole ring's."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import MonitorSession, fake_mesh

    mesh = fake_mesh((8,), ("data",), device="cuda")
    group = mesh.get_group("data")

    def ring(x):
        for _ in range(RING_STEPS):
            buf = torch.empty_like(x)
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, 1, group),
                    dist.P2POp(dist.irecv, buf, 7, group)]):
                w.wait()
            x = buf

    sess = MonitorSession(mesh=mesh, name="ring")
    with sess.fake_mode:
        x = torch.empty(BATCH * PROMPT_LEN, 4096, dtype=torch.bfloat16,
                        device="cuda")
    sess.capture(ring, x)
    rep = sess.report()
    got = {"traced": {k: (r["calls"], r["payload_bytes"])
                      for k, r in rep.traced_summary.items()},
           "compiled": {k: (r["calls"], r["payload_bytes"])
                        for k, r in rep.compiled_summary.items()}}
    log(f"[monitor] batch_isend_irecv ring, {RING_STEPS} steps on a fake "
        f"8-way cuda mesh: (calls, payload bytes) {got}")
    if got != RING_MONITOR:
        fail(f"ring capture {got} != expected {RING_MONITOR}")
    ring_pairs = [(r, (r + 1) % 8) for r in range(8)]
    if any(op.source_target_pairs != ring_pairs for op in rep.compiled_ops):
        fail("ring capture: a SendRecv's pairs are not the whole ring's")


# Phase 6's fleet sizes per architecture (the 4096- and 16384-device points
# are held against the reference in tests/test_torch_scale.py, on small op
# streams: a full-width capture routes its COO entries one at a time)
SCALE_POINTS = {"qwen3_8b": (256, 1024), "recurrentgemma_2b": (256,)}


def check_batched(ops, algorithm: str, topo, what: str) -> None:
    """The batched engine's weighted ``total_time_split`` against the
    per-op sum over fresh ``decompose`` calls, bitwise."""
    from repro_torch.core.decompose import ScheduleBatch, decompose

    got = ScheduleBatch.from_ops(ops, algorithm, topo).total_time_split()
    ici = dcn = 0.0
    for op in ops:
        i, d = decompose(op, algorithm, topo, warn=False).time_split(topo)
        w = max(1.0, float(op.weight))
        ici += i * w
        dcn += d * w
    if got != (ici, dcn):
        fail(f"{what}: batched total_time_split {got} != per-op sum "
             f"{(ici, dcn)}")
    log(f"[scale] {what}: batched total_time_split == per-op sum, bitwise "
        f"(ici {got[0] * 1e3:.6f} ms, dcn {got[1] * 1e3:.6f} ms, "
        f"{len(ops)} ops)")


def run_scale(arch: str, rep) -> list:
    """Phase 6 for one architecture's full-width capture: its scale curve,
    each point's COO matrix and link view held against the dense ones, and
    batched timing against per-op timing.  Returns the points."""
    import numpy as np

    from repro_torch import scale
    from repro_torch.core import comm_matrix as cm

    check_batched(rep.compiled_ops, rep.algorithm, rep.topo,
                  f"{arch} capture ({rep.num_devices} devices)")
    points = []
    for n in SCALE_POINTS[arch]:
        t0 = time.perf_counter()
        (p,) = scale.scale_curve([rep], (n,))
        wall = time.perf_counter() - t0
        points.append(p)
        log(scale.scale_table([p]))
        log(f"[scale] {arch} {n} devices ({p.pods} pods, {p.ops} ops): nnz "
            f"{p.nnz}, sparse build {p.build_ms:.1f} ms, bottleneck "
            f"{p.bottleneck_link} {p.bottleneck_ms:.6f} ms, point wall "
            f"{wall:.2f} s")
        ops = scale.scale_ops(rep.compiled_ops, rep.num_devices, n)
        topo = scale.fleet_topology(n)
        t0 = time.perf_counter()
        coo = cm.matrix_for_ops(ops, n, rep.algorithm, topo=topo,
                                sparse=True)
        dense = cm.matrix_for_ops(ops, n, rep.algorithm, topo=topo,
                                  sparse=False)
        if coo.nnz != p.nnz or not np.array_equal(coo.to_dense(), dense):
            fail(f"{arch} {n} devices: the COO matrix differs from the "
                 "dense one")
        lu_coo = cm.project_links(coo, topo)
        lu_dense = cm.project_links(dense, topo)
        if lu_coo.bytes_by_link != lu_dense.bytes_by_link:
            fail(f"{arch} {n} devices: links projected from COO differ from "
                 "those projected from the dense matrix")
        bn = lu_coo.bottleneck()
        if (bn[0].name, bn[1] * 1e3) != (p.bottleneck_link, p.bottleneck_ms):
            fail(f"{arch} {n} devices: the point's bottleneck differs from "
                 "the projection's")
        log(f"[scale] {arch} {n} devices: COO == dense entry for entry "
            f"({coo.nnz} entries), link views equal over "
            f"{len(lu_coo.bytes_by_link)} links (check "
            f"{time.perf_counter() - t0:.2f} s)")
        check_batched(ops, rep.algorithm, topo, f"{arch} {n} devices")
    return points


def trace_step(name: str, step, params, batch) -> Path:
    """One more live step under ``torch.profiler`` (CPU and CUDA, shapes
    recorded), its Chrome trace written under ``build/`` for phase 7."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = ROOT / "build" / f"chip_smoke_{name}_step.pt.trace.json"
    path.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    log(f"[train] {name} one step profiled with shapes: "
        f"{path.relative_to(ROOT)} ({path.stat().st_size / 2**20:.1f} MiB)")
    return path


def run_train() -> tuple[dict, dict]:
    """Phase 4: every paper application trained on the card over a one-rank
    NCCL group, its first step held against the same step on the CPU (a
    one-rank gloo group).  Returns each application's live all-reduces per
    step and the Chrome trace of one more profiled step."""
    import torch
    import torch.distributed as dist

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import paper as launch
    from repro_torch.models.common import tree_leaves

    group = launch.open_group("cuda")
    cpu_group = dist.new_group([0], backend="gloo")
    live, traces = {}, {}
    for name in PAPER_APPS:
        app = launch.make_app(name)
        res = launch.train(app, group, steps=TRAIN_STEPS, device="cuda")
        losses = res["losses"]
        log(f"[train] {name}: {TRAIN_STEPS} DDP steps of global batch "
            f"{app.data.global_batch} on the card: median step "
            f"{res['median_step_ms']:.3f} ms (steps 2-{TRAIN_STEPS}) | "
            f"{res['samples_per_s']:.1f} samples/s | max memory "
            f"{res['max_memory_bytes'] / 2**30:.3f} GiB | "
            f"{res['allreduce_calls']} all-reduces a step")
        log(f"[train] {name} losses {[round(v, 4) for v in losses]}; step ms "
            f"{[round(v, 3) for v in res['step_ms']]}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"{name}: non-finite loss {losses}")
        if name == "resnet" and not losses[-1] < losses[0]:
            fail(f"resnet did not learn: loss {losses[0]} -> {losses[-1]}")
        # the first step on the CPU from the same weights and batch
        cpu = launch.train(app, cpu_group, steps=1, device="cpu")
        start = tree_leaves(launch.init_app_params(app, 0, "cpu"))
        p_err = d_err = d_max = p_max = 0.0
        for p0, g, c in zip(start, tree_leaves(res["first_params"]),
                            tree_leaves(cpu["first_params"])):
            p_err = max(p_err, (g - c).abs().max().item())
            p_max = max(p_max, c.abs().max().item())
            d_err = max(d_err, ((g - p0) - (c - p0)).abs().max().item())
            d_max = max(d_max, (c - p0).abs().max().item())
        # fp32 on both sides, summed in other orders (cuBLAS/cuDNN against
        # the CPU's kernels): the parameters to 1e-5 of their largest; the
        # update itself to 1e-3 of its largest, plus one fp32 rounding of
        # the largest parameter (the update is read back as p1 - p0)
        p_tol = 1e-5 * max(1.0, p_max)
        d_tol = 1e-3 * d_max + torch.finfo(torch.float32).eps * p_max
        log(f"[train] {name} first step, card against CPU: parameters "
            f"max_abs_err {p_err:.3e} (tol {p_tol:.3e}), update max_abs_err "
            f"{d_err:.3e} (tol {d_tol:.3e}: 1e-3 of max |update| "
            f"{d_max:.3e} + eps x max |p| {p_max:.3f}); CPU loss "
            f"{cpu['losses'][0]:.6f}, card {losses[0]:.6f}")
        if not (p_err <= p_tol and d_err <= d_tol):
            fail(f"{name}: the first step on the card differs from the CPU's")
        live[name] = res["allreduce_calls"]
        # where one step's time goes, from the start weights and batch, and
        # the least time its matmuls and convolutions could take in fp32
        step = app.step_fn(group)
        params = launch.init_app_params(app, 0, "cuda")
        batch = app.data.batch_at(0, "cuda")
        profile_window(f"{name} train step", lambda: step(params, batch))
        traces[name] = trace_step(name, step, params, batch)
        with FlopCounterMode(display=False) as flops:
            step(params, batch)
        b_ms = flops.get_total_flops() / FP32_FLOPS * 1e3
        log(f"[train] {name} one step: {flops.get_total_flops() / 1e9:.2f} "
            f"GFLOP in matmuls and convolutions (FlopCounterMode), fp32 "
            f"bound {b_ms:.3f} ms at 67 TFLOP/s = "
            f"{b_ms / res['median_step_ms']:.3f} of the median step")
        del res, cpu, params, batch
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return live, traces


# Phase 7's lint findings of every phase-5 capture, rule -> count.  A
# ``cuda`` mesh's shard-to-shard redistribution is one all-to-all, which no
# rule flags; GNMT's startup Broadcast is an all-gather of 8 copies of
# which the program keeps rank 0's (``sweep.broadcast_params``), one
# ``allgather-then-slice`` a gathered parameter (16 of its 17 all-gathers;
# the 17th, the metrics gather, keeps every rank's loss)
LINT_COUNTS = {
    "qwen3_8b": {},
    "recurrentgemma_2b": {},
    "resnet": {},
    "gnmt": {"allgather-then-slice": 16},
    "paper": {},
}


def run_trace(traces: dict, live: dict, captures: dict) -> None:
    """Phase 7: each paper application's profiled live step imported and
    compared with its phase-5 capture, then every capture linted."""
    from collections import Counter

    from repro_torch.core import CommReport
    from repro_torch.core.trace import load_trace, sniff_format

    for name in PAPER_APPS:
        path = traces[name]
        t0 = time.perf_counter()
        fmt = sniff_format(str(path))
        if fmt != "torch":
            fail(f"{name}: {path.name} sniffed as {fmt!r}, not 'torch'")
        imp = load_trace(str(path), name=f"{name} live step")
        measured = imp.report()
        load_s = time.perf_counter() - t0
        capture = captures[name]
        got = [op.payload_bytes for op in measured.compiled_ops
               if op.kind == "all-reduce"]
        want = [op.payload_bytes for op in capture.compiled_ops
                if op.kind == "all-reduce"]
        log(f"[trace] {name}: {path.name} imported in {load_s:.2f} s: "
            f"{len(measured.compiled_ops)} collectives, timing sources "
            f"{imp.meta['timing']}; {len(got)} all-reduces "
            f"({sum(got):.0f} B), live step {live[name]}")
        if len(got) != live[name]:
            fail(f"{name}: the trace holds {len(got)} all-reduces, a live "
                 f"step issued {live[name]}")
        if got != want:
            fail(f"{name}: measured all-reduce payloads {got} != the "
                 f"capture's {want}")
        res = measured.compare(capture)
        log(res.table(title=f"{name}: measured live step (1 rank, NCCL) "
                            f"against its capture on a fake 8-way mesh"))
        kinds = res.by_kind()
        # a host span times the call, not NCCL's work on the card
        what = ("host spans" if set(imp.meta["timing"]) == {"cpu_annotation"}
                else "device")
        log(f"[trace] {name} ms by kind, measured ({what}) "
            f"{ {k: b['measured_s'] * 1e3 for k, b in kinds.items()} }, "
            f"modeled { {k: b['modeled_s'] * 1e3 for k, b in kinds.items()} }")
        if res.unmatched_measured:
            fail(f"{name}: {res.unmatched_measured} measured ops matched no "
                 "captured op")
        if not all(r.rel_err is not None and math.isfinite(r.rel_err)
                   for r in res.rows):
            fail(f"{name}: a matched row has no finite relative error")
    for name, rep in captures.items():
        t0 = time.perf_counter()
        findings = rep.lint()
        lint_s = time.perf_counter() - t0
        log(rep.lint_table())
        counts = dict(Counter(f.rule_id for f in findings))
        log(f"[lint] {name}: {len(findings)} findings {counts} in "
            f"{lint_s:.3f} s over {len(rep.compiled_ops)} ops")
        if counts != LINT_COUNTS[name]:
            fail(f"{name}: lint findings {counts} != expected "
                 f"{LINT_COUNTS[name]}")
        path = ROOT / "build" / f"chip_smoke_{name}_lint_report.json"
        rep.save(str(path), include_lint=True)
        back = CommReport.load(str(path))
        if [f.to_dict() for f in back.lint()] != \
                [f.to_dict() for f in findings]:
            fail(f"{name}: findings reloaded from {path.name} differ")
        log(f"[lint] {name}: saved with include_lint and reloaded: findings "
            "equal")


KERNEL_META = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:19"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:35"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:28"),
    "rglru": ("src/repro_torch/kernels/csrc/rglru.cu",
              "src/repro/kernels/rglru/kernel.py:24"),
}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {len(build.SOURCES)} CUDA sources built in "
        f"{time.perf_counter() - t0:.1f} s")

    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    kernels = check_kernels()
    grad_errs = check_kernel_grads()
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_arch = {}
    for arch in ARCHS:
        by_arch[arch], res = run_serve(arch)
        profile_serve(res)
        del res        # free this model before the next one is built
        gc.collect()
        torch.cuda.empty_cache()
    seconds["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    live, traces = run_train()
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reports = {arch: run_monitor(arch) for arch in ARCHS}
    for name in PAPER_APPS:
        reports[name] = run_paper_monitor(name, live[name])
    run_ring_monitor()
    seconds["monitor"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch in ARCHS:
        run_scale(arch, reports[arch])
    seconds["scale"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_trace(traces, live, reports)
    seconds["trace"] = time.perf_counter() - t0

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1],
         "launches": sum(c[name] for c in by_arch.values()),
         "launches_by_arch": {a: c[name] for a, c in by_arch.items()},
         **{k: kernels[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
         "grad_max_abs_err": grad_errs[name]}
        for name in KERNEL_META],
        "phase_seconds": {k: round(v, 3) for k, v in seconds.items()}}
    log(json.dumps(line))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
