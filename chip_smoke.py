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
              floor (an 8-element add); flash attention also at the
              lm-train phase's microbatch (one 1024-token sequence);
              the transformer-backbone configs' shapes: flash attention
              and flash decode (the 160-slot serve cache) at MHA 32/32
              dh 128, MHA 24/24 dh 64, MQA 48/1 dh 128 and 64/8 dh 128,
              decode also at 32/8 dh 64; flash decode's partial on a
              sequence-sharded (``kv_seq``) cache: Qwen3-8B's 160-slot
              serve cache and RecurrentGemma-2B's wrapped 2048-slot ring,
              each cut into 4 and 16 shards launched at their
              ``kv_offset``s and merged on the card by ``lse_combine``,
              against the unsplit kernel and the plain version (the time
              the shards' launches, the merge's logged apart), and one
              rank's share of Qwen3-8B's decode_32k on the 16x16 mesh
              (q (8,32,128) over (8,2048,8,128) at kv_offset 2048, its
              fp32 output and log-sum-exp); flash attention as the
              context-parallel branch runs it (a causal S=512 problem in 4
              sequence shards, each at its ``q_offset``, against the
              unsplit kernel and the plain version); RMSNorm at widths
              1536, 2048, 5120, 6144 and 8192 (prefill and decode rows) and
              Chameleon-34B's 64-head qk rows; the MoE configs' attention
              (flash attention and flash decode at Grok-1's 48/8 and
              Llama-4 Maverick's 40/8 heads of 128: query groups of 6
              and 5); the reduced Qwen3-8B that the examples phase serves
              (RMSNorm rows of 64 and qk rows of 16, flash attention at
              4/4 heads of 16 over its 32-token prompt, flash decode over
              its 56-slot cache at the first and the last step), before
              the example runs them.
              RG-LRU's forward and backward kernels at its serve prefill
              and decode shapes, the lm-train microbatch (1,1024,2560), a
              ragged (1,1000,2560) and a long (1,8192,2560), each with the
              kernel tests' inputs and in the model's regime (a near 1),
              the forward within 1e-4 of ``rglru_ref`` and each backward
              output within 1e-5 of max(1, max|ref|) of ``rglru_bwd``,
              and both bit for bit equal to their split mirrors
              (``rglru_split_ref``, ``rglru_bwd_split_ref``), with each
              launch plan; the backward also at a transposed and an
              expanded cotangent.  Then the registers and spills of
              every kernel instance launched.  Then the gradient check:
              backward through each of the four ops at the serve paths'
              prefill shapes (and RG-LRU's decode step) against backward
              through its plain version on the card, at the forward's
              tolerance; each op's forward must launch its kernel once,
              RG-LRU's backward its backward kernel once, the other
              backwards (plain formulas) none;
3. serve   -- for each served architecture (Qwen3-8B, RecurrentGemma-2B,
              then the transformer-backbone configs CodeQwen1.5-7B,
              Granite-3-2B, Granite-20B, Chameleon-34B and MusicGen-medium,
              then xLSTM-1.3B (48 layers of mLSTM and sLSTM blocks, whose
              only kernel is RMSNorm: 97 launches a step), then the
              Mixture-of-Experts configs Grok-1 and Llama-4
              Maverick), at its published width and depth (the MoE
              configs' depth cut to 6 and 2 layers: ``SERVE_LAYERS``),
              random weights from a seed, cast to bf16 once: 8 requests, prompt 128, 32 new
              tokens, timed by the serve entry point; the two configs that
              read embeddings (Chameleon, MusicGen: stubbed front ends)
              through ``model.prefill`` and 31 ``decode_step``s on bf16
              embeddings drawn from a seeded generator on the card, timed
              on the same host clock.  Then one more ``generate`` of the
              same requests (or run over the same embeddings), with the launch
              counters zeroed just before and read just after: they must
              equal the counts the architecture's layers imply (every norm
              through the RMSNorm kernel, prefill attention through the
              flash-attention kernel, decode attention through the
              flash-decode kernel, every recurrence through the RG-LRU
              kernel; an MoE block launches none of the port's kernels).
              The first decode step's logits are held against the
              same step with the plain versions (for an MoE model the top-k
              choices of each layer that differ between the two are
              printed; where a flip breaks the check, the sequences whose
              routing agrees in every layer are held, at the same
              tolerance), and torch.profiler shows
              where one prefill's and four decode steps' device time goes,
              with the device's idle share.  Qwen3-8B's prefill is counted
              (FLOPs, bytes) for phase 8.  Each model is freed before the
              next is built (the memory resident before each build is
              printed: Chameleon-34B's 63.88 GiB of weights need the card
              to itself); an MoE model also prints its weights' bytes over
              the HBM rate, the bound of a decode step that reads every
              expert;
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
lm-train   -- LM training through ``repro_torch.launch.train`` on one card:
              RecurrentGemma-2B at its published width and depth, then
              Qwen3-8B at its published width cut to 8 layers (36 would
              not fit), each freed before the next: 10 steps of the TRAIN
              preset (8 microbatches of one 1024-token sequence, remat
              full) from random fp32 weights, AdamW with fp32 moments.
              The launch counters are zeroed just before the run and read
              just after: they must be 10 x ``expected_train_launches``.
              Losses must be finite and the last below the first; the
              median step (steps 2-10), tokens/s and peak memory are
              printed.  The first step is run again from the same start
              with each kernel launch replaced by its plain version and
              held to the kernels' loss and gradient norm (1e-4 of
              each); one more step is profiled (device busy and idle
              share); in the step after it, CUDA events around each call
              of the attention plain backward and the RG-LRU backward
              kernel give their share of that step; the step's bf16 FLOP
              bound is printed.  Then each
              reduced config, 2 steps in fp32 on the card against the CPU
              from the same start, and 4 steps straight against 2, a
              checkpoint, a resume and 2 more;
examples   -- the user examples (``examples/torch_*.py``) on the card, each
              through its ``main(argv)`` in this process:
              torch_image_classification at the paper's 64x64 (150 DDP
              steps of ResNet-18 over a one-rank NCCL group, its last
              accuracy above 0.5; at the default 30 steps a 64x64 run
              ends above 0.5 in only some runs, the reference's own
              example too), torch_translation (150 AdamW steps of a
              small GNMT, its last loss under 0.7 of its first, then its
              three-phase capture) and torch_serve_lm (the reduced Qwen3-8B
              served, 8 x (32 + 24) tokens, then its two-phase capture; its
              kernel launches, counted from zero just before, must equal
              ``expected_launches`` of its warm-up and its timed
              generate).  An example's own assertion fails the run.  Then
              ``python -m repro_torch monitor examples/torch_quickstart.py``
              in a subprocess: exit 0 and its roofline line.  Each
              example's wall seconds, the training examples' median step
              ms, accuracy or loss and all-reduces a step, and the serve
              example's tokens/s are printed;
5. monitor -- for each served architecture, the two-phase prefill/decode
              capture at full width and depth on a fake 4x2 mesh, under
              FakeTensorMode on ``cuda``; its per-phase collective calls
              must equal a pinned table, and the report is saved, reloaded
              and compared; and, for Qwen3-8B and RecurrentGemma-2B, the
              train step (the TRAIN preset's remat, one microbatch,
              8 x 128 tokens) at full width and depth, its calls and
              payload bytes by kind held to a pinned table.  Then
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
              and a reload;
8. cli     -- the port's command line, ``python -m repro_torch``, in
              subprocesses on the card (captures on fake ``cuda`` meshes,
              a report cache under ``build/cli``): ``configs`` must list
              the fifteen sweep configs (the paper apps, serve, moe-skew
              and the ten architectures' reduced train steps); ``sweep``
              of every config on
              4x2 and 2x2x2 with ring and hierarchical, by phase and
              linted, run
              twice: the cold run captures each (config, mesh) cell once,
              the warm run captures nothing and hits the cache for every
              cell, the summary CSV keeps the reference's header and each
              cell's calls by kind equal a pinned table; ``monitor serve``
              writes the JSON, CSV, HTML (one heatmap panel a phase) and
              Perfetto exports, and the JSON reloads to the cache entry's
              views; ``lint paper --mesh 2x2x2 --fail-on error`` exits 1
              with ring and 0 with hierarchical; ``lint moe-skew --mesh
              4x2 --fail-on warn`` exits 1 with two ``skewed-a2a``
              findings; ``compare`` of phase 7's
              live MLP trace against its saved capture matches every
              measured op; ``sweep --scale-curve --configs serve`` (256 and
              1024 devices) writes the reference's 13-column CSV and the
              HTML curve.  Then the
              roofline of phase 5's two full-width captures, and the H100
              bound of the Qwen3-8B prefill that phase 3 counted with
              ``repro_torch.core.op_cost`` (live on the card and again under
              FakeTensorMode: the counts must be equal) -- FLOPs over
              989 TFLOP/s bf16 or bytes over 3.35 TB/s, the larger -- which
              must not exceed that prefill's measured device busy time;
9. dryrun  -- ``python -m repro_torch dryrun`` in subprocesses started
              together, on fake ``cuda`` production meshes (16x16 and
              2x16x16): every ported architecture's decode_32k on both
              (the MoE configs' in processes of their own: Grok-1's
              TP-experts layout and Llama-4's expert parallelism),
              xLSTM-1.3B's and RecurrentGemma-2B's long_500k on both
              (``--mesh both``), and
              Qwen3-8B's prefill_32k and train_4k on the single pod, each
              at its published size; and, under ``--sp --tag sp`` (the
              Sharder's ``seq -> model`` rule), Qwen3-8B's prefill_32k and
              train_4k, RecurrentGemma-2B's prefill_32k (conv, scan and
              local attention over sequence shards) and xLSTM-1.3B's
              prefill_32k (both recurrences) on the single pod.  Every
              cell must be ``ok``, and a decode cell's cache bytes per
              device must equal ``dryrun.cache_bytes_per_device``
              (Qwen3-8B's 2.42 GB on 16x16); each cell's trace seconds and
              total bytes a device are printed, and each ``--sp`` cell's
              collectives by kind (calls and bytes) beside its cell
              without ``--sp`` where the phase runs one.

Then one JSON line with every kernel's numbers (flash decode's with its
``kv_seq`` rank share, whose ``launches`` are the partial op's in the
serve phase: 0, the card being a mesh of model 1; a kernel's ``launches``
are those of its main path: the serve phase's, summed over the ten
served architectures, and the serve example's, each named in
``launches_by_arch``, RG-LRU's backward kernel's the lm-train phase's),
each served model's times, the examples' numbers,
busy ms and idle shares, the lm-train numbers, the dry-run cells' trace
seconds and bytes and each phase's seconds,
the card's name and power limit as nvidia-smi prints them, and, last, the
device line.  The script
needs ``src/repro_torch`` beside it and a CUDA device, and imports nothing of
JAX.
"""
from __future__ import annotations

import contextlib
import functools
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
# the transformer-backbone configs served and captured beside them (the
# last two read stub embeddings); the train, scale and trace phases keep
# to ARCHS
BACKBONE_ARCHS = ("codeqwen15_7b", "granite_3_2b", "granite_20b",
                  "chameleon_34b", "musicgen_medium")
# the Mixture-of-Experts configs, served at their published width and cut
# in depth to the most layers whose bf16 weights stay near Chameleon-34B's
# 63.88 GiB (Grok-1: 6 of 64 layers, 57.99 GiB; 7 would be 67.15 GiB;
# Llama-4 Maverick: 2 of 48, 64.09 GiB, one layer's experts 32 GiB),
# captured at full depth
MOE_ARCHS = ("grok_1_314b", "llama4_maverick_400b_a17b")
SERVE_LAYERS = {"grok_1_314b": 6, "llama4_maverick_400b_a17b": 2}
# xLSTM-1.3B (2.62 B parameters, 5.25 GB of bf16 weights) at its published
# width and depth: 24 (mLSTM, sLSTM) superblocks, no attention
SSM_ARCHS = ("xlstm_1_3b",)
SERVE_ARCHS = ARCHS + BACKBONE_ARCHS + SSM_ARCHS + MOE_ARCHS
BATCH, PROMPT_LEN, NEW_TOKENS = 8, 128, 32
PAPER_APPS = ("resnet", "gnmt", "paper")
TRAIN_STEPS = 10
# the lm-train phase: each architecture at its published width (depth cut
# where one card cannot hold the state: None keeps it), the TRAIN preset,
# global batch 8 x 1024 tokens, the reference launcher's 10 warm-up steps.
# Peak lr 3e-4, a tenth of the launcher's 3e-3: at 3e-3 both full-width
# models diverged within ten steps on the H100 (losses 12.94 -> 13.95 and
# 12.44 -> 13.42, spikes to 18.4 and 16.9), Adam moving every weight of
# std ~0.02 by up to 3e-3 a step
LM_ARCHS = {"recurrentgemma_2b": None, "qwen3_8b": 8}
LM_BATCH, LM_SEQ, LM_LR = 8, 1024, 3e-4
# the examples phase: the user examples of examples/torch_*.py at their
# defaults, the image classification at the paper's 64x64 (its default 32
# is for the CPU) and for 150 steps: at 64x64 its default 30 end above its
# 0.5 accuracy in 5 of 8 card runs from the same seeds (the card's
# arithmetic is not deterministic), 150 in every run (PERF.md §6).
# torch_serve_lm serves the reduced Qwen3-8B (4 layers, d 64, 4 query and
# 4 kv heads of 16, vocab 512): 8 requests, a 32-token prompt, 24 new
# tokens, a cache of 56 slots
EXAMPLE_RUNS = (("image_classification", ("--image-size", "64",
                                          "--steps", "150")),
                ("translation", ()), ("serve_lm", ()))
EX_BATCH, EX_PROMPT, EX_TOKENS, EX_HEADS, EX_DH, EX_D = 8, 32, 24, 4, 16, 64
EX_SLOTS = EX_PROMPT + EX_TOKENS
# its RMSNorm rows: (case, shape, kind)
EXAMPLE_NORMS = (
    ("rows(B*S,64)", (EX_BATCH * EX_PROMPT, EX_D), "prefill"),
    ("qk(B,S,4,16)", (EX_BATCH, EX_PROMPT, EX_HEADS, EX_DH), "prefill"),
    ("decode rows(B,64)", (EX_BATCH, EX_D), "decode"),
    ("decode qk(B,1,4,16)", (EX_BATCH, 1, EX_HEADS, EX_DH), "decode"))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def gpu_name_and_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


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
    RecurrentGemma-2B's rows, the other served configs' widths 1536, 2048,
    6144 and 8192 and Chameleon-34B's 64 query heads, and the rows of the
    reduced Qwen3-8B that ``examples/torch_serve_lm.py`` serves (width 64,
    qk rows of 16); prefill cases are timed cold too.  Kind
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
    ] + [
        # the transformer-backbone configs' model widths (MusicGen-medium,
        # Granite-3-2B, Llama-4 Maverick, Granite-20B and Grok-1,
        # Chameleon-34B: the block kernel's run-time width instances) and
        # Chameleon's 64 query heads' qk rows
        (f"{k}rows({r},{d})", (n, d), bf16, kind, 0)
        for d in (1536, 2048, 5120, 6144, 8192)
        for k, r, n, kind in (("", "B*S", rows, "prefill"),
                              ("decode ", "B", BATCH, "decode"))
    ] + [
        ("qk(B,S,64,128)", (BATCH, PROMPT_LEN, 64, 128), bf16, "prefill", 0),
        ("decode qk(B,1,64,128)", (BATCH, 1, 64, 128), bf16, "decode", 0),
    ] + [
        # the reduced Qwen3-8B that examples/torch_serve_lm.py serves: d 64,
        # 4 query and 4 kv heads of 16, 8 requests of a 32-token prompt
        (f"example {case}", shape, bf16, kind, 0)
        for case, shape, kind in EXAMPLE_NORMS
    ] + [
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
# launch counters
# ---------------------------------------------------------------------------
def kernel_counters() -> dict:
    """Each kernel's launch counter, by kernel name: the wrapper module and
    the attribute its CUDA branch adds one to at every launch (RG-LRU's
    and flash attention's wrappers count their forward and backward kernels
    apart, flash decode's its whole-cache and its partial op)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops

    return {"rmsnorm": (rn_ops, "launches"),
            "flash_attention": (fa_ops, "launches"),
            "flash_decode": (fd_ops, "launches"),
            "flash_decode_partial": (fd_ops, "partial_launches"),
            "rglru": (rg_ops, "launches"),
            "rglru_bwd": (rg_ops, "bwd_launches"),
            "flash_attention_bwd": (fa_ops, "bwd_launches")}


def zero_counts() -> None:
    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in kernel_counters().items()}


# ---------------------------------------------------------------------------
# RG-LRU's cases and timings (also timed for another source tree by
# tools/rglru_bench.py)
# ---------------------------------------------------------------------------
D_RNN = 2560
RGLRU_REGIMES = ("softplus", "a_near_1")


def rglru_cases() -> list:
    """(case, (B, S, D), with h0): RecurrentGemma-2B's serve prefill from a
    zero state, its decode step carrying h0 and the lm-train phase's
    microbatch; then at B=1 a ragged S carrying h0 (the split kernels' h0
    row and dh0), a long S (rounds of a cluster's tiles) and an odd width
    carrying h0 (4-byte copies, a ragged channel tile)."""
    return [("prefill (8,128,2560)", (BATCH, PROMPT_LEN, D_RNN), False),
            ("decode (8,1,2560) h0", (BATCH, 1, D_RNN), True),
            ("train (1,1024,2560)", (1, LM_SEQ, D_RNN), False),
            ("ragged (1,1000,2560) h0", (1, 1000, D_RNN), True),
            ("long (1,8192,2560)", (1, 8192, D_RNN), False),
            ("odd width (1,1024,1001) h0", (1, LM_SEQ, 1001), True)]


def rglru_inputs(shape, with_h0: bool, regime: str, gen) -> tuple:
    """(x, log_a, h0, dy) fp32 on the card.  "softplus": x ~ N(0, 1),
    log_a = -softplus(N(0, 1)) (a ~ 0.5), the kernel tests' inputs.
    "a_near_1": the model's regime, log a uniform in [-1e-3, 0] and x scaled
    by sqrt(1 - a^2) as ``rglru_apply`` scales it, so h stays of order 1
    while every carry crosses many sub-chunks.  dy ~ N(0, 1); h0 ~ N(0, 1)
    or None."""
    import torch
    import torch.nn.functional as F

    def randn():
        return torch.randn(*shape, generator=gen, device=gen.device)

    x = randn()
    if regime == "a_near_1":
        la = -1e-3 * torch.rand(*shape, generator=gen, device=gen.device)
        x = torch.sqrt(1.0 - torch.exp(2.0 * la)) * x
    else:
        la = -F.softplus(randn())
    h0 = (torch.randn(shape[0], shape[2], generator=gen, device=gen.device)
          if with_h0 else None)
    return x, la, h0, randn()


def rglru_plain_iters(s: int) -> dict:
    """time_ms arguments for the plain versions, Python loops over S (~3
    launches a step): fewer calls at long S, so that each timing takes a
    few seconds at most."""
    return dict(iters=max(1, min(20, 2048 // s)), reps=5 if s <= 1024 else 3)


def rglru_times(x, la, h0, dy, *, plain: bool = True) -> dict:
    """The forward and backward kernels' median times on these inputs and
    their bounds (bytes: the forward reads x and log_a and writes h, plus
    h0; the backward reads dy, log_a and h and writes dx and dlog_a, plus
    h0 and dh0), and with ``plain`` the plain versions' times."""
    import torch

    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_bwd, rglru_ref

    n, s = x.numel(), x.shape[1]
    hb = 0 if h0 is None else h0.numel() * 4
    h = rglru_ref(x, la, h0)
    bwd_op = torch.ops.repro_torch.rglru_scan_bwd
    t = {}
    t["ms"] = time_ms(lambda: rg_ops.rglru_scan(x, la, h0))
    t["bound_ms"], t["bound_by"] = bound_ms(3 * n * 4 + hb, 3 * n,
                                            FP32_FLOPS)
    t["bwd_ms"] = time_ms(lambda: bwd_op(dy, la, h, h0))
    t["bwd_bound_ms"], t["bwd_bound_by"] = bound_ms(5 * n * 4 + 2 * hb,
                                                    5 * n, FP32_FLOPS)
    if plain:
        kw = rglru_plain_iters(s)
        t["plain_ms"] = time_ms(lambda: rglru_ref(x, la, h0), **kw)
        t["bwd_plain_ms"] = time_ms(lambda: rglru_bwd(dy, la, h, h0), **kw)
    return t


def rglru_launch(plan, shape, backward: bool) -> str:
    """A launch plan as phase 2 logs it, the grid as ``rglru_plan`` defines
    it and the shared memory as ``csrc/rglru.cu`` sets it
    (``repro_rglru_smem``)."""
    import ctypes

    from repro_torch.kernels import build

    b, s, d = shape
    if plan.variant == "walk":
        return (f"walk, grid ({-(-d // 256)}, {b}) x 256 threads (one a "
                "channel), no shared memory")
    smem = (ctypes.c_int * 2)()
    build.check("rglru", build.library("rglru").repro_rglru_smem(
        s, plan.cluster, plan.warps, plan.steps, ctypes.addressof(smem)))
    span = plan.cluster * plan.warps * plan.steps
    return (f"split, cluster {plan.cluster} x {plan.warps} warps x "
            f"{plan.steps} rows, grid ({plan.cluster}, {-(-d // 32)}, {b}) "
            f"x {32 * plan.warps} threads, {-(-s // span)} round(s), "
            f"{smem[int(backward)]} B shared memory")


# ---------------------------------------------------------------------------
# flash attention's backward kernels: cases, checks and timings (the cases
# also run by the card tests in tests/test_torch_flash_attention_chip.py)
# ---------------------------------------------------------------------------
# (case, b, sq, skv, h, kvh, dh, causal, window, q_offset, dtype name):
# the three training shapes (Granite-3-2B's microbatch in the benchmark's
# train cell, the lm-train phase's Qwen3-8B and RecurrentGemma-2B), then
# groups of 1, 8 and MQA 48/1, non-causal, windows, q_offset with Sq < Skv
# (a sequence-parallel shard), ragged Sq/Skv, rows that see no key, a head
# dim that pads its k-steps (40), one that takes element-wise loads (100),
# the reduced model's 16, and f16
FLASH_BWD_TRAIN = (
    ("granite train gqa 32/8 dh64 B4 S1024", 4, 1024, 1024, 32, 8, 64, True,
     0, 0, "bfloat16"),
    ("qwen train gqa 32/8 dh128 B1 S1024", 1, 1024, 1024, 32, 8, 128, True,
     0, 0, "bfloat16"),
    ("rg train mqa 10/1 dh256 B1 S1024 window2048", 1, 1024, 1024, 10, 1,
     256, True, 2048, 0, "bfloat16"),
)
FLASH_BWD_CASES = FLASH_BWD_TRAIN + (
    ("mha 8/8 dh64 non-causal B2 S256", 2, 256, 256, 8, 8, 64, False, 0, 0,
     "bfloat16"),
    ("gqa 64/8 dh128 B2 S256", 2, 256, 256, 64, 8, 128, True, 0, 0,
     "bfloat16"),
    ("mqa 48/1 dh128 B2 S256", 2, 256, 256, 48, 1, 128, True, 0, 0,
     "bfloat16"),
    ("gqa 32/8 dh128 window100 B2 S300", 2, 300, 300, 32, 8, 128, True, 100,
     0, "bfloat16"),
    ("mqa 10/1 dh256 window100 B2 S256", 2, 256, 256, 10, 1, 256, True, 100,
     0, "bfloat16"),
    ("q_offset128 Sq64 Skv192 gqa 32/8 dh64", 2, 64, 192, 32, 8, 64, True, 0,
     128, "bfloat16"),
    ("q_offset96 Sq100 Skv200 window50 gqa 16/4 dh128", 1, 100, 200, 16, 4,
     128, True, 50, 96, "bfloat16"),
    ("ragged Sq100 gqa 32/8 dh64", 2, 100, 100, 32, 8, 64, True, 0, 0,
     "bfloat16"),
    ("ragged non-causal Sq77 Skv133 gqa 8/2 dh128", 2, 77, 133, 8, 2, 128,
     False, 0, 0, "bfloat16"),
    ("masked rows Sq64 Skv48 q_offset40 window20 gqa 8/2 dh64", 2, 64, 48, 8,
     2, 64, True, 20, 40, "bfloat16"),
    ("all rows masked Sq64 Skv64 q_offset200 window100 gqa 8/2 dh128", 1, 64,
     64, 8, 2, 128, True, 100, 200, "bfloat16"),
    ("dh40 gqa 8/2 S128", 2, 128, 128, 8, 2, 40, True, 0, 0, "bfloat16"),
    ("dh100 gqa 8/2 S128", 2, 128, 128, 8, 2, 100, True, 0, 0, "bfloat16"),
    ("dh16 mha 4/4 B8 S32", 8, 32, 32, 4, 4, 16, True, 0, 0, "bfloat16"),
    ("f16 gqa 32/8 dh64 B2 S256", 2, 256, 256, 32, 8, 64, True, 0, 0,
     "float16"),
)
# gradients of order 1 in bf16/f16: the forward kernel's 2e-2, of max(1,
# the largest plain gradient); P and dS are rounded to the input dtype as
# operands and each gradient once on the way out (2^-9 relative each in
# bf16), against the plain version's fp32 throughout
FLASH_BWD_TOL = 2e-2


def flash_bwd_inputs(case, gen) -> tuple:
    """q, k, v and the output cotangent of a case, drawn on the card."""
    import torch

    _, b, sq, skv, h, kvh, dh, _, _, _, dtype = case

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            getattr(torch, dtype))

    return (randn(b, sq, h, dh), randn(b, skv, kvh, dh),
            randn(b, skv, kvh, dh), randn(b, sq, h, dh))


def flash_bwd_check(case, gen) -> dict:
    """One case: ``attend`` forward and backward on the card against the
    plain backward (``attention_bwd``) in fp32 on the same values.  A row
    that sees no key takes a zero cotangent for the comparison, since the
    plain version gives such a row the uniform softmax: the kernel's dq
    there must be exactly 0, and its dk and dv what the zeroed cotangent
    gives, bit for bit.  A repeat must equal the first call bit for bit
    (no atomics), and the forward and backward counters rise by one each.
    Returns the numbers."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd, visible

    _, b, sq, skv, h, kvh, dh, causal, window, q_offset, _ = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = flash_bwd_inputs(case, gen)
    seen = visible(sq, skv, device="cuda", **kw).any(-1)
    do_seen = do * seen[None, :, None, None].to(do.dtype)

    def grads(dy):
        ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        fa_ops.attend(*ts, **kw).backward(dy)
        return [t.grad for t in ts]

    before = (fa_ops.launches, fa_ops.bwd_launches)
    got = grads(do)
    torch.cuda.synchronize()
    counts = (fa_ops.launches - before[0], fa_ops.bwd_launches - before[1])
    again, zeroed = grads(do), grads(do_seen)
    want = attention_bwd(do_seen.float(), q.float(), k.float(), v.float(),
                         **kw)
    errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
    tols = [FLASH_BWD_TOL * max(1.0, w.abs().max().item()) for w in want]
    torch.cuda.synchronize()
    return {"errs": errs, "tols": tols,
            "finite": all(bool(torch.isfinite(g).all()) for g in got),
            "unseen_dq_zero": not bool(got[0][:, ~seen].any()),
            "unseen_rows_add_nothing": all(
                torch.equal(g, z) for g, z in zip(got, zeroed)),
            "repeat_equal": all(torch.equal(g, a)
                                for g, a in zip(got, again)),
            "counts": counts, "unseen_rows": int((~seen).sum().item())}


def flash_bwd_ok(r: dict) -> bool:
    return (r["finite"] and all(e <= t for e, t in zip(r["errs"], r["tols"]))
            and r["unseen_dq_zero"] and r["unseen_rows_add_nothing"]
            and r["repeat_equal"] and r["counts"] == (1, 1))


def flash_bwd_times(case, gen) -> dict:
    """Median device ms of one backward at a case's shape: the kernels
    (``_launch_bwd`` from a saved forward), the plain ``attention_bwd``
    and, as the library's yardstick, SDPA's own backward (timed only,
    never called by the port); the forward with and without its lse; the
    bound of five products over the visible pairs at 989 TFLOP/s or of q,
    k, v, o, dO read and dq, dk, dv written once at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd, visible

    _, b, sq, skv, h, kvh, dh, causal, window, q_offset, _ = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = flash_bwd_inputs(case, gen)
    o, lse = fa_ops._launch_lse(q, k, v, causal, window, q_offset)
    t = {"fwd_ms": time_ms(lambda: fa_ops._launch(q, k, v, causal, window,
                                                  q_offset)),
         "fwd_lse_ms": time_ms(lambda: fa_ops._launch_lse(
             q, k, v, causal, window, q_offset)),
         "ms": time_ms(lambda: fa_ops._launch_bwd(
             do, q, k, v, o, lse, causal, window, q_offset))}
    del o, lse
    t["plain_ms"] = time_ms(lambda: attention_bwd(do, q, k, v, **kw),
                            iters=5, reps=3)
    mask = visible(sq, skv, device="cuda", **kw)
    plain_causal = (causal and not q_offset and sq == skv
                    and (not window or window >= skv))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=None if plain_causal else mask,
        is_causal=plain_causal, enable_gqa=True)
    dot = do.transpose(1, 2)
    t["library_ms"] = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    pairs = int(mask.sum().item())
    t["bound_ms"], t["bound_by"] = bound_ms(
        q.element_size() * 4 * (q.numel() + k.numel()),
        10.0 * b * h * pairs * dh)
    return t


def check_flash_bwd(launched: dict) -> dict:
    """Phase 2's backward check: every case of :data:`FLASH_BWD_CASES`
    held by :func:`flash_bwd_check`, then the three training shapes timed
    (:func:`flash_bwd_times`).  Returns the numbers for the JSON line."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    errs, abs_errs, train_shapes, main = [], [], {}, None
    for case in FLASH_BWD_CASES:
        r = flash_bwd_check(case, gen)
        launched["flash_attention_bwd"].add((getattr(torch, case[-1]),
                                             case[6]))
        ok = flash_bwd_ok(r)
        log(f"[kernels] flash_attention_bwd {case[0]}: max_abs_err dq/dk/dv "
            + "/".join(f"{e:.3e}" for e in r["errs"]) + " (tol "
            + "/".join(f"{t:.3g}" for t in r["tols"]) + f"); finite "
            f"{r['finite']}, {r['unseen_rows']} rows see no key (dq 0: "
            f"{r['unseen_dq_zero']}, add nothing: "
            f"{r['unseen_rows_add_nothing']}), repeat bit for bit "
            f"{r['repeat_equal']}, launches fwd/bwd {r['counts']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_attention_bwd {case[0]}: {r}")
        errs.append(max(e / t for e, t in zip(r["errs"], r["tols"])))
        abs_errs.append(max(r["errs"]))
    for case in FLASH_BWD_TRAIN:
        t = flash_bwd_times(case, gen)
        log(f"[kernels] flash_attention_bwd {case[0]}: kernel "
            f"{t['ms']:.4f} ms | bound {t['bound_ms']:.4g} ms "
            f"({t['bound_by']}) | plain {t['plain_ms']:.4f} ms | library "
            f"(SDPA backward) {t['library_ms']:.4f} ms | forward "
            f"{t['fwd_ms']:.4f} ms, with lse {t['fwd_lse_ms']:.4f} ms")
        train_shapes[case[0]] = t
        if main is None:
            main = {k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")}
    return dict(main, max_abs_err=max(abs_errs), max_err_over_tol=max(errs),
                train_shapes=train_shapes)


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
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import (rglru_bwd,
                                               rglru_bwd_split_ref,
                                               rglru_ref, rglru_split_ref)
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
                "flash_decode": set(), "flash_attention_bwd": set()}
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
    errs, main, train_shapes = [], None, {}
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
             f32, 2e-5),
            # the lm-train phase's microbatch: one 1024-token sequence
            ("train qwen B1 S1024", LM_SEQ, LM_SEQ, 32, 8, 128, 0, 0, bf16,
             2e-2),
            ("train rg B1 S1024 window2048", LM_SEQ, LM_SEQ, 10, 1, 256,
             2048, 0, bf16, 2e-2),
            # the transformer-backbone configs' prefill head layouts:
            # CodeQwen1.5-7B's MHA, MusicGen-medium's MHA at dh 64,
            # Granite-20B's MQA, Chameleon-34B's 64/8 (Granite-3-2B's 32/8
            # at dh 64 is the "dh64" case)
            *((f"{name} B8 S128", PROMPT_LEN, PROMPT_LEN, h, kvh, dh, 0, 0,
               bf16, 2e-2) for name, h, kvh, dh in NEW_HEADS + MOE_HEADS),
            # torch_serve_lm's prefill: the reduced Qwen3-8B's 4/4 heads of
            # 16 (the dh-64 instance, k-steps cut at 16) over its prompt
            (f"example mha 4/4 dh16 B8 S{EX_PROMPT}", EX_PROMPT, EX_PROMPT,
             EX_HEADS, EX_HEADS, EX_DH, 0, 0, bf16, 2e-2)):
        nb = 1 if case.startswith("train") else BATCH
        q = randn(nb, sq, h, dh).to(dtype)
        k = randn(nb, skv, kvh, dh).to(dtype)
        v = randn(nb, skv, kvh, dh).to(dtype)

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
                         4 * nb * h * pairs * dh,
                         FP32_FLOPS if dtype == f32 else BF16_FLOPS)
        record("flash_attention", case, err, tol, ms, plain_ms, lib, b, by)
        if nb == 1:
            train_shapes[case] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=lib, bound_ms=b,
                                      max_abs_err=err)
        errs.append(err)
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b,
                        bound_by=by)
    errs.append(check_cp_shards(record, randn, launched))
    results["flash_attention"] = dict(main, max_abs_err=max(errs),
                                      train_shapes=train_shapes)

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
    # 100 (not a multiple of 8: element-wise loads).  The transformer-backbone
    # configs' head layouts (``NEW_HEADS`` and Granite-3-2B's 32/8 at dh 64)
    # decode the 160-slot serve cache from its first step; the reduced
    # Qwen3-8B of the examples phase its 56-slot one.
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
    cases += [(f"{name} cache_len 129 L{slots}", 129, h, kvh, dh, slots, 0,
               bf16, bf16) for name, h, kvh, dh in
              NEW_HEADS + MOE_HEADS + (("gqa 32/8 dh64", 32, 8, 64),)]
    # torch_serve_lm's decode: 4/4 heads of 16 over its 56-slot cache, at
    # the first step and the last
    cases += [(f"example mha 4/4 dh16 cache_len {n} L{EX_SLOTS}", n,
               EX_HEADS, EX_HEADS, EX_DH, EX_SLOTS, 0, bf16, bf16)
              for n in (EX_PROMPT + 1, EX_SLOTS)]
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
        blocks = fd_ops.head_blocks(h // kvh, dh)
        log(f"[kernels] flash_decode {case}: nsplit "
            f"{fd_ops.splits_for(q, kc)} ({BATCH * kvh * blocks} (b, kv "
            f"head, block of {h // kvh // blocks} heads) groups)")
        record("flash_decode", case, err, tol, ms, plain, lib, b, by)
        errs.append(err)
        if main is None:
            main = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                        bound_by=by)
    kv_errs, share = check_decode_shards(record, randn, launched)
    results["flash_decode"] = dict(main, max_abs_err=max(errs + kv_errs),
                                   kv_seq=share)

    # -- RG-LRU, forward and backward kernels: every case of rglru_cases()
    # in both input regimes, each against the plain versions on the same
    # inputs (the backward at the plain forward's h).  No single PyTorch
    # call computes a linear recurrence, so there is no library time
    fwd_tol = 1e-4   # the same fp32 recurrence; only composed carries differ
    bwd_op = torch.ops.repro_torch.rglru_scan_bwd
    fwd_errs, bwd_errs, main, main_bwd = [], [], None, None
    train_shapes, bwd_train_shapes = {}, {}
    for case, shape, with_h0 in rglru_cases():
        plan = rg_ops.rglru_plan(*shape, build.sm_count(0))
        bplan = rg_ops.rglru_plan(*shape, build.sm_count(0), backward=True)
        log(f"[kernels] rglru {case}: forward "
            f"{rglru_launch(plan, shape, False)}; backward "
            f"{rglru_launch(bplan, shape, True)}")
        for regime in RGLRU_REGIMES:
            x, la, h0, dy = rglru_inputs(shape, with_h0, regime, gen)
            label = f"{case} {regime}"
            out = rg_ops.rglru_scan(x, la, h0)
            torch.cuda.synchronize()
            h = rglru_ref(x, la, h0)
            err = (out - h).abs().max().item()
            got = bwd_op(dy, la, h, h0)
            torch.cuda.synchronize()
            want = rglru_bwd(dy, la, h, h0)
            # the kernels against their own arithmetic (ref.py's split
            # mirrors: the same plan's sub-chunks and carries in plain
            # PyTorch on the card), bit for bit
            mirror = rglru_bwd_split_ref(dy, la, h, h0, bplan)
            same = (torch.equal(out, rglru_split_ref(x, la, h0, plan)),
                    all(torch.equal(g, m) for g, m in zip(got, mirror)
                        if m is not None))
            log(f"[kernels] rglru {label}: forward / backward kernel equal "
                f"to the split mirror bit for bit: {same[0]} / {same[1]}")
            if not all(same):
                fail(f"rglru {label}: a kernel differs from its split "
                     f"mirror (forward, backward equal: {same})")
            # fp32 reverse scan: inside a sub-chunk the kernel's dx and
            # dlog_a are the plain version's bit for bit from the same
            # carry; only the composed carries round differently, a few
            # ulps at each of up to 512 sub-chunk boundaries (S=8192).  On
            # an H100 80GB HBM3 the errors read at most 2.1e-6 to 2.7e-6 of
            # max(1, max|ref|) at S=8192 with a near 1, where the scan sums
            # dy over ~1000 steps (|g| up to ~300): 1e-5 of it per output
            berr = babs = 0.0
            for what, g, w in zip(("dx", "dlog_a", "dh0"), got, want):
                if w is None:
                    continue
                scale = max(1.0, w.abs().max().item())
                e = (g - w).abs().max().item()
                ok = e <= 1e-5 * scale
                log(f"[kernels] rglru_bwd {label}: {what} max_abs_err "
                    f"{e:.3e} (tol {1e-5 * scale:.3e} = 1e-5 x max(1, "
                    f"max|ref| {scale:.3g})) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"rglru_bwd {label} {what}: max abs err {e} > "
                         f"{1e-5 * scale}")
                berr, babs = max(berr, e / scale), max(babs, e)
            t = rglru_times(x, la, h0, dy)
            record("rglru", label, err, fwd_tol, t["ms"], t["plain_ms"],
                   None, t["bound_ms"], t["bound_by"])
            log(f"[kernels] rglru_bwd {label}: kernel {t['bwd_ms']:.4f} ms | "
                f"bound {t['bwd_bound_ms']:.4g} ms ({t['bwd_bound_by']}) | "
                f"plain {t['bwd_plain_ms']:.4f} ms | library n/a")
            fwd_errs.append(err)
            bwd_errs.append((babs, berr))
            row = dict(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=None,
                       bound_ms=t["bound_ms"], max_abs_err=err)
            brow = dict(ms=t["bwd_ms"], plain_ms=t["bwd_plain_ms"],
                        library_ms=None, bound_ms=t["bwd_bound_ms"],
                        max_abs_err=babs, max_rel_err=berr)
            if shape[0] == 1:
                train_shapes[label] = row
                bwd_train_shapes[label] = brow
            if main is None:
                main = dict(row, bound_by=t["bound_by"])
                main_bwd = dict(ms=t["bwd_ms"], plain_ms=t["bwd_plain_ms"],
                                library_ms=None, bound_ms=t["bwd_bound_ms"],
                                bound_by=t["bwd_bound_by"])
            del x, la, h0, dy, out, h, got, want, mirror
    # the cotangent autograd hands the backward: not the caller's layout
    # (the model's ``h, h[:, -1]`` sums two, one expanded); the wrapper makes
    # it contiguous
    x, la, _, _ = rglru_inputs(rglru_cases()[0][1], False, "softplus", gen)
    h = rglru_ref(x, la, None)
    b_, s_, d_ = x.shape
    for what, dy in (
            ("transposed", torch.randn(b_, d_, s_, generator=gen,
                                       device=dev).transpose(1, 2)),
            ("expanded", torch.randn(b_, 1, d_, generator=gen,
                                     device=dev).expand(b_, s_, d_))):
        got = bwd_op(dy, la, h, None)
        want = rglru_bwd(dy, la, h, None)
        errs = [((g - w).abs().max().item(), max(1.0, w.abs().max().item()))
                for g, w in zip(got[:2], want[:2])]
        rel = max(e / m for e, m in errs)
        log(f"[kernels] rglru_bwd prefill, {what} dy: max_rel_err "
            f"{rel:.3e} (tol 1e-05 of max(1, max|ref|)) "
            f"{'ok' if rel <= 1e-5 else 'FAIL'}")
        if rel > 1e-5:
            fail(f"rglru_bwd with a {what} dy differs: {rel}")
        bwd_errs.append((max(e for e, _ in errs), rel))
    results["rglru"] = dict(main, max_abs_err=max(fwd_errs),
                            train_shapes=train_shapes)
    results["rglru_bwd"] = dict(
        main_bwd, max_abs_err=max(e for e, _ in bwd_errs),
        max_rel_err=max(r for _, r in bwd_errs),
        train_shapes=bwd_train_shapes)
    results["flash_attention_bwd"] = check_flash_bwd(launched)
    check_kernel_attrs(launched)
    return results


# the transformer-backbone configs' attention layouts beyond Qwen3-8B's and
# the dh-64 32/8 case: (name, query heads, kv heads, head dim)
# the MoE configs' layouts: Grok-1's 48 and Llama-4's 40 query heads over 8
# kv heads of 128 (query groups of 6 and 5, not powers of two)
MOE_HEADS = (("gqa 48/8 dh128", 48, 8, 128), ("gqa 40/8 dh128", 40, 8, 128))
NEW_HEADS = (("mha 32/32 dh128", 32, 32, 128), ("mha 24/24 dh64", 24, 24, 64),
             ("mqa 48/1 dh128", 48, 1, 128), ("gqa 64/8 dh128", 64, 8, 128))
CP_SHARDS, CP_SEQ = 4, 512


def check_cp_shards(record, randn, launched) -> float:
    """The context-parallel branch's kernel calls: a causal S=512 problem
    (MusicGen-medium's 24 heads of 64, B8) with q split into 4 sequence
    shards, each launched at its global ``q_offset`` against the whole k/v
    (as ``attention_block`` runs each shard); the concatenation against
    the kernel's unsplit output and the plain version.  Timed as the four
    shard launches; the library time is SDPA's unsplit causal call.
    Returns the error against the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    h, dh, s, n = 24, 64, CP_SEQ, CP_SEQ // CP_SHARDS
    q, k, v = randn(BATCH, s, h, dh), randn(BATCH, s, h, dh), \
        randn(BATCH, s, h, dh)
    parts = [q[:, r * n:(r + 1) * n].contiguous() for r in range(CP_SHARDS)]

    def shards():
        return [fa_ops.attend(p, k, v, causal=True, q_offset=r * n)
                for r, p in enumerate(parts)]

    def plain():
        return [attention_ref(p, k, v, causal=True, q_offset=r * n)
                for r, p in enumerate(parts)]

    got = torch.cat(shards(), dim=1).float()
    whole = fa_ops.attend(q, k, v, causal=True).float()
    torch.cuda.synchronize()
    launched["flash_attention"].add((q.dtype, dh))
    err = (got - attention_ref(q, k, v, causal=True).float()).abs().max()
    split = (got - whole).abs().max().item()
    # a row's keys, tiles and sums do not depend on the other rows of its
    # launch, and each shard starts on a 64-row tile: bit for bit
    log(f"[kernels] flash_attention cp shards: {CP_SHARDS} x Sq{n} at "
        f"q_offset 0..{(CP_SHARDS - 1) * n} against the unsplit kernel: "
        f"max_abs_diff {split:.3e} (bit for bit: {split == 0.0})")
    if split != 0.0:
        fail(f"flash_attention cp shards differ from the unsplit kernel by "
             f"{split}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = BATCH * h * s * (s + 1) // 2
    b, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                     4 * pairs * dh)
    record("flash_attention", f"cp {CP_SHARDS} shards of S{s} mha 24/24 "
           "dh64", err.item(), 2e-2, time_ms(shards), time_ms(plain),
           time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True)), b, by)
    return err.item()


# the sequence-sharded (``kv_seq``) cache's partial decode: the serve
# paths' caches cut into 4 and 16 shards, and one rank's share of Qwen3-8B's
# decode_32k cell on the 16x16 production mesh (batch 128 over data 16,
# 32768 slots over model 16: slots [2048, 4096) at model coordinate 1)
KVSEQ_SHARDS = (4, 16)
KVSEQ_SHARE = dict(batch=8, heads=32, kv_heads=8, dh=128, slots=2048,
                   kv_offset=2048, lmax=32768)


def check_decode_shards(record, randn, launched) -> tuple:
    """The partial decode kernel (``decode_attend_partial``) as the model
    runs it on a sequence-sharded cache.  Qwen3-8B's 160-slot serve cache
    (cache_len 129) and RecurrentGemma-2B's 2048-slot ring after it wraps
    (cache_len 2148), each cut into 4 and 16 shards, every shard launched
    at its ``kv_offset`` against the global L, the fp32 partials merged on
    the card by ``lse_combine`` and rounded once to q's dtype (as the
    model's merge does): held against the unsplit kernel and the plain
    version at the decode tolerance.  The time is the shards' partial
    launches alone, beside the plain partials' and the bound of the same
    work; the merge (a plain-PyTorch log-sum-exp over a list, which the
    model does with two all-reduces instead) is timed apart and logged.
    Then one rank's share of Qwen3-8B's decode_32k (:data:`KVSEQ_SHARE`),
    its fp32 output and log-sum-exp against the plain partial, timed
    beside its bytes bound and SDPA over the same shard.  Returns (errors,
    the share's numbers; the caller adds its launches from the serve
    run's counts)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import (decode_partial_ref,
                                                      decode_ref, lse_combine)

    dev = torch.device("cuda")
    slots = PROMPT_LEN + NEW_TOKENS
    errs = []
    for case, clen, h, kvh, dh, lmax in (
            (f"qwen cache_len 129 L{slots}", 129, 32, 8, 128, slots),
            ("ring cache_len 2148 L2048", 2048 + 100, 10, 1, 256, 2048)):
        kc, vc = randn(BATCH, lmax, kvh, dh), randn(BATCH, lmax, kvh, dh)
        q = randn(BATCH, h, dh)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        whole = fd_ops.decode_attend(q, kc, vc, cl).float()
        ref = decode_ref(q, kc, vc, cl).float()
        tol = torch.finfo(q.dtype).eps * ref.abs().max().item()
        for p in KVSEQ_SHARDS:
            n = lmax // p
            shards = [(kc[:, r * n:(r + 1) * n].contiguous(),
                       vc[:, r * n:(r + 1) * n].contiguous(), r * n)
                      for r in range(p)]

            def partials(partial):
                return [partial(q, k_, v_, cl, kv_offset=off, lmax=lmax)
                        for k_, v_, off in shards]

            def kernel():
                return partials(fd_ops.decode_attend_partial)

            def plain():
                return partials(decode_partial_ref)

            def merge(parts):
                return lse_combine([o for o, _ in parts],
                                   [l for _, l in parts])[0].to(q.dtype)

            parts = kernel()
            got = merge(parts).float()
            torch.cuda.synchronize()
            launched["flash_decode"].add((q.dtype, kc.dtype))
            err = (got - ref).abs().max().item()
            split = (got - whole).abs().max().item()
            log(f"[kernels] flash_decode {case} in {p} kv_seq shards of {n} "
                f"slots: against the unsplit kernel max_abs_diff "
                f"{split:.3e} (tol {tol:g})")
            if split > tol:
                fail(f"flash_decode {case}: {p} merged shards differ from "
                     f"the unsplit kernel by {split} > {tol}")
            merge_ms = time_ms(lambda: merge(parts))
            log(f"[kernels] flash_decode {case} in {p} kv_seq shards: the "
                f"merge (lse_combine over {p} partials) {merge_ms:.4f} ms, "
                "not in the kernel's time")
            live = min(clen, lmax)
            kt, vt = (t[:, :live].transpose(1, 2) for t in (kc, vc))
            # the live keys' k/v and q read by every shard; each shard's
            # fp32 output and log-sum-exp written
            b, by = bound_ms(2 * BATCH * live * kvh * dh * 2
                             + p * q.numel() * 2
                             + p * (q.numel() + BATCH * h) * 4,
                             4 * BATCH * h * live * dh)
            record("flash_decode", f"{case} in {p} kv_seq shards", err, tol,
                   time_ms(kernel), time_ms(plain),
                   time_ms(lambda: F.scaled_dot_product_attention(
                       q[:, :, None], kt, vt, enable_gqa=True)), b, by)
            errs.append(err)

    sh = KVSEQ_SHARE
    kc = randn(sh["batch"], sh["slots"], sh["kv_heads"], sh["dh"])
    vc = randn(sh["batch"], sh["slots"], sh["kv_heads"], sh["dh"])
    q = randn(sh["batch"], sh["heads"], sh["dh"])
    cl = torch.tensor(sh["lmax"], dtype=torch.int32, device=dev)
    kw = dict(kv_offset=sh["kv_offset"], lmax=sh["lmax"])

    def kernel():
        return fd_ops.decode_attend_partial(q, kc, vc, cl, **kw)

    out, lse = kernel()
    torch.cuda.synchronize()
    ref, ref_lse = decode_partial_ref(q, kc, vc, cl, **kw)
    err = (out - ref).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    # fp32 outputs of bf16 inputs: the merge rounds to q's dtype after, so
    # the output is held to the decode tolerance; the log-sum-exp (base-2
    # sums, then one log2) to 1e-5 of max(1, max|ref|)
    tol = torch.finfo(q.dtype).eps * ref.abs().max().item()
    lse_tol = 1e-5 * max(1.0, ref_lse.abs().max().item())
    log(f"[kernels] flash_decode decode_32k rank share: lse max_abs_err "
        f"{lse_err:.3e} (tol {lse_tol:.3e})")
    if lse_err > lse_tol:
        fail(f"flash_decode decode_32k share: lse err {lse_err} > {lse_tol}")
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    b, by = bound_ms(2 * kc.numel() * 2 + q.numel() * 2 + out.numel() * 4
                     + lse.numel() * 4,
                     4 * sh["batch"] * sh["heads"] * sh["slots"] * sh["dh"])
    ms = time_ms(kernel)
    plain = time_ms(lambda: decode_partial_ref(q, kc, vc, cl, **kw))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, enable_gqa=True))
    record("flash_decode", "decode_32k rank share q (8,32,128) over "
           "(8,2048,8,128) at kv_offset 2048", err, tol, ms, plain, lib, b,
           by)
    errs.append(err)
    return errs, dict(
        shape=[list(q.shape), list(kc.shape)], kv_offset=sh["kv_offset"],
        lmax=sh["lmax"], max_abs_err=err, lse_max_abs_err=lse_err,
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)


def check_kernel_grads() -> dict:
    """Phase 2's gradient check: each op's backward against autograd
    through the plain version itself, both on the card, at the serve
    paths' shapes and the forward's tolerance.  Each op's forward must
    launch its kernel once; RG-LRU's and flash attention's backwards must
    each call their backward kernels once, the others' backwards (plain
    formulas) none.  Returns each kernel's max abs gradient error (RG-LRU's
    and flash attention's under both of their kernels' names)."""
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
    # (kernel, case, op, plain, inputs, tol): bf16 at the forward's 2e-2;
    # flash attention, whose backward is its kernels, at two bf16 ulps of
    # the largest gradient (both sides round each gradient to bf16 once;
    # the kernel's bf16 P and dS operands add the rest: one ulp, 0.0625 of
    # a largest gradient of ~11, on an H100); flash decode at one ulp;
    # RG-LRU fp32 at 1e-4
    cases = [
        ("rmsnorm", "rows(B*S,4096)", rn_ops, lambda x, w: rn_ops.rmsnorm(
            x, w, 1e-6), lambda x, w: rmsnorm_ref(x, w, 1e-6),
         [randn(rows, 4096), 1.0 + 0.1 * randn(4096)], 2e-2),
        ("flash_attention", "causal B8 S128", fa_ops,
         lambda q, k, v: fa_ops.attend(q, k, v, causal=True),
         lambda q, k, v: attention_ref(q, k, v, causal=True),
         [randn(BATCH, PROMPT_LEN, 32, 128), randn(BATCH, PROMPT_LEN, 8, 128),
          randn(BATCH, PROMPT_LEN, 8, 128)],
         lambda want: 2 * torch.finfo(bf16).eps * max(
             w.abs().max().item() for w in want)),
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
        before = (mod.launches, getattr(mod, "bwd_launches", 0))
        got = grads(op, inputs, dy)
        torch.cuda.synchronize()
        n = (mod.launches - before[0],
             getattr(mod, "bwd_launches", 0) - before[1])
        want_n = (1, 1 if name in ("rglru", "flash_attention") else 0)
        if n != want_n:
            fail(f"{name} {case}: the forward launched its kernel {n[0]} "
                 f"times and the backward its kernel {n[1]} times, not "
                 f"{want_n[0]} and {want_n[1]}")
        want = grads(plain, inputs, dy)
        if tol is None:
            tol = torch.finfo(bf16).eps * max(w.abs().max().item()
                                              for w in want)
        elif callable(tol):
            tol = tol(want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        log(f"[grad] {name} {case}: max_abs_err {err:.3e} over "
            f"{len(got)} input gradients (tol {tol:g}; backward: "
            f"{'its kernel' if want_n[1] else 'plain formula'}) "
            f"{'ok' if finite and err <= tol else 'FAIL'}")
        if not (finite and err <= tol):
            fail(f"{name} {case}: gradient differs from the plain "
                 f"version's: {err} > {tol}")
        errs[name] = max(errs.get(name, 0.0), err)
    errs["rglru_bwd"] = errs["rglru"]
    errs["flash_attention_bwd"] = errs["flash_attention"]
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
    the kernel phase launched, as the CUDA runtime reports them: RMSNorm by
    (dtype, width, plan), flash attention by (dtype, head dim) (bf16/f16:
    the serving instance and the one that writes lse) and its four
    backward kernels by (dtype, head dim), flash decode's split kernel by
    (q dtype, cache dtype) and its combine by q dtype, RG-LRU's three
    kernels (forward walk and split, backward).  Any local memory fails
    the run."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import ops as rn_ops

    code, name_of = build.DTYPE_CODES, lambda dt: str(dt).split(".")[-1]
    out = (ctypes.c_int * 8)()
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
        if dtype != torch.float32:
            rows.append((f"flash_attention {name_of(dtype)} dh{dh} with lse",
                         out[2], out[3]))
    for dtype, dh in sorted(launched["flash_attention_bwd"], key=str):
        build.check("flash_attention", build.library(
            "flash_attention").repro_flash_attention_bwd_attrs(
                code[dtype], dh, ctypes.addressof(out)))
        for i, part in enumerate(("prep", "dK/dV", "dQ", "partial sums")):
            rows.append((f"flash_attention_bwd {part} {name_of(dtype)} "
                         f"dh{dh}", out[2 * i], out[2 * i + 1]))
    for qdt, kvdt in sorted(launched["flash_decode"], key=str):
        build.check("flash_decode", build.library(
            "flash_decode").repro_flash_decode_attrs(
                code[qdt], code[kvdt], ctypes.addressof(out)))
        rows.append((f"flash_decode split {name_of(qdt)}/{name_of(kvdt)}",
                     out[0], out[1]))
        rows.append((f"flash_decode combine {name_of(qdt)}", out[2], out[3]))
    rg = (ctypes.c_int * 6)()
    build.check("rglru", build.library("rglru").repro_rglru_attrs(
        ctypes.addressof(rg)))
    for i, name in enumerate(("forward walk", "forward split",
                              "backward split")):
        rows.append((f"rglru {name}", rg[2 * i], rg[2 * i + 1]))
    for name, regs, local in dict.fromkeys(rows):
        log(f"[kernels] {name}: {regs} registers, {local} B local memory "
            "a thread")
        if local != 0:
            fail(f"{name} uses {local} B of local memory a thread (spills)")


def expected_launches(cfg, steps: int) -> dict:
    """Kernel launches of one prefill and ``steps`` decode steps: per
    prefill and per decode step two RMSNorms a layer (norm1 and norm2; an
    xLSTM block's norm and head norm), two more per attention layer with
    qk-norm, and the final norm (xLSTM-1.3B: 97); per prefill one flash
    attention an attention layer, per decode step one flash decode an
    attention layer; per prefill and per decode step one RG-LRU scan a
    recurrent layer (``cfg.block_kind`` names each layer's kind; xLSTM's
    mLSTM and sLSTM layers launch none of the four); no backward, and no
    partial decode (the card is a mesh of model 1)."""
    n = cfg.n_layers
    n_attn = sum(cfg.block_kind(i) == "attn" for i in range(n))
    n_rec = sum(cfg.block_kind(i) == "rec" for i in range(n))
    norms = 2 * n + 1 + (2 * n_attn if cfg.qk_norm else 0)
    return {"rmsnorm": (1 + steps) * norms, "flash_attention": n_attn,
            "flash_decode": steps * n_attn, "flash_decode_partial": 0,
            "rglru": (1 + steps) * n_rec, "rglru_bwd": 0,
            "flash_attention_bwd": 0}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def prefill_batch(res) -> dict:
    """The served prompts: token ids, or the stub front end's embeddings
    for a config that reads them."""
    if "embeds" in res:
        return {"embeds": res["embeds"]}
    return {"tokens": res["prompts"]}


def step_batch(res, i: int, logits) -> dict:
    """Decode step ``i``'s input: the greedy token of ``logits`` (fed
    back), or the ``i``-th drawn step embedding."""
    if "embeds" in res:
        return {"embeds": res["step_embeds"][:, i:i + 1]}
    last = logits if logits.dim() == 2 else logits[:, -1]
    return {"tokens": last.float().argmax(-1)[:, None]}


def serve_embeddings(cfg) -> dict:
    """Serve a config that reads embeddings (Chameleon-34B, MusicGen-medium)
    as ``launch.serve.serve`` serves a token config, which refuses it: bf16
    weights from seed 0, ``BATCH`` prompts of ``PROMPT_LEN`` embeddings and
    ``NEW_TOKENS - 1`` step embeddings drawn in bf16 from a seeded
    generator on the card (standing in for the stubbed modality front end,
    as the reference's ``input_specs`` do), one untimed run, then the timed
    prefill and decode steps on the same host clock ending in
    ``synchronize``.  Returns the keys ``serve`` returns, plus the inputs."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.parallel import Sharder

    model = build_model(cfg)
    params = model.init(0, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {"model": model, "params": params, "embeds": torch.randn(
        BATCH, PROMPT_LEN, cfg.d_model, generator=gen, device="cuda").to(
            torch.bfloat16), "step_embeds": torch.randn(
        BATCH, NEW_TOKENS - 1, cfg.d_model, generator=gen,
        device="cuda").to(torch.bfloat16)}
    marks: list = []

    def clock():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    embed_generate(res, Sharder())
    torch.cuda.reset_peak_memory_stats()
    clock()
    res["tokens"] = embed_generate(res, Sharder(), clock=clock)
    return dict(res, prefill_ms=(marks[1] - marks[0]) * 1e3,
                decode_ms_per_token=(marks[2] - marks[1]) * 1e3
                / (NEW_TOKENS - 1),
                tokens_per_s=BATCH * NEW_TOKENS / (marks[2] - marks[0]),
                max_memory_bytes=torch.cuda.max_memory_allocated())


def embed_generate(res, shd, clock=None):
    """One prefill over the prompt embeddings and ``NEW_TOKENS - 1``
    decode steps over the step embeddings; ``clock`` is called after the
    prefill and after the last step.  Returns the (B, NEW_TOKENS) greedy
    tokens of every step's logits."""
    import torch

    model, params = res["model"], res["params"]
    with torch.inference_mode():
        logits, cache = model.prefill(params, prefill_batch(res), shd,
                                      max_len=PROMPT_LEN + NEW_TOKENS)
        toks = [logits.float().argmax(-1)]
        if clock is not None:
            clock()
        for i in range(NEW_TOKENS - 1):
            logits, cache = model.decode_step(params, cache,
                                              step_batch(res, i, logits), shd)
            toks.append(logits[:, -1].float().argmax(-1))
        out = torch.stack(toks, dim=1)
        if clock is not None:
            clock()
    return out


def run_serve(arch: str) -> tuple[dict, dict]:
    """Phase 3 for one architecture at full width and depth: a token config
    through the port's serve entry point, an embeddings config through
    :func:`serve_embeddings`; then the counted main-path run: one more
    ``generate`` (or :func:`embed_generate`) over the same inputs, with
    every launch count zeroed just before it and read just after.
    (Each serve runs an untimed warm-up before its timed run, so counts
    taken around it would hold the warm-up's launches too.)  Returns the
    counted run's launch counts and the serve result."""
    from unittest import mock

    import torch

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import decode_ref
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.launch import serve as launch
    from repro_torch.parallel import Sharder
    from repro_torch.serve import generate

    cfg = launch.model_config(arch, SERVE_LAYERS.get(arch))
    embeds = cfg.input_mode == "embeddings"
    if embeds:
        res = serve_embeddings(cfg)
    else:
        res = launch.serve(cfg, batch=BATCH, prompt_len=PROMPT_LEN,
                           tokens=NEW_TOKENS, device="cuda")
    log(f"[serve] {cfg.name} d{cfg.d_model} {cfg.n_layers} layers, {BATCH} "
        f"requests x prompt {PROMPT_LEN} + {NEW_TOKENS} tokens"
        + (" (bf16 embeddings from a seeded generator)" if embeds else "")
        + f": prefill {res['prefill_ms']:.2f} ms | decode "
        f"{res['decode_ms_per_token']:.2f} ms/token | "
        f"{res['tokens_per_s']:.1f} tok/s | max memory "
        f"{res['max_memory_bytes'] / 2**30:.2f} GiB | {gpu_name_and_limit()}")

    model, params, shd = res["model"], res["params"], Sharder()
    zero_counts()
    if embeds:
        toks = embed_generate(res, shd)
    else:
        toks = generate(model, params, res["prompts"], shd,
                        steps=NEW_TOKENS, max_len=PROMPT_LEN + NEW_TOKENS)
    torch.cuda.synchronize()
    counts = read_counts()
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

    if cfg.n_experts:
        log_moe_bound(cfg, params)

    # first decode step: kernels against the plain versions on the card;
    # each MoE layer's top-k choices of both runs recorded
    routes: dict = {"kernel": [], "plain": []}
    with torch.inference_mode():
        logits0, cache = model.prefill(params, prefill_batch(res), shd,
                                       max_len=PROMPT_LEN + NEW_TOKENS)
        step = step_batch(res, 0, logits0)
        plain_cache = _clone(cache)
        with recorded_routes(routes["kernel"]):
            got, _ = model.decode_step(params, cache, step, shd)
        with mock.patch.object(rn_ops, "rmsnorm", rmsnorm_ref), \
                mock.patch.object(fd_ops, "decode_attend", decode_ref), \
                mock.patch.object(rg_ops, "rglru_scan", rglru_ref), \
                recorded_routes(routes["plain"]):
            want, _ = model.decode_step(params, plain_cache, step, shd)
    del cache, plain_cache
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
    same_rows = routing_flips(cfg, routes)
    if not err <= tol and same_rows is not None and bool(same_rows.any()) \
            and not bool(same_rows.all()):
        # a routing flip (a discrete choice on bf16 inputs) sends a
        # sequence through other experts: hold the sequences whose routing
        # agrees in every layer, at the same tolerance
        err = (got - want)[same_rows].abs().max().item()
        log(f"[serve] {cfg.name} routing flipped: the {int(same_rows.sum())} "
            f"of {BATCH} sequences whose routing agrees in every layer: "
            f"max_abs_err {err:.4f} (tol {tol:.4f})")
    if not err <= tol:
        fail(f"decode logits differ from the plain versions: {err} > {tol}")
    return counts, res


@contextlib.contextmanager
def recorded_routes(into: list):
    """Record each MoE layer's top-k expert choices (``moe.route``'s
    ``gate_idx``), in call order, while the block runs."""
    from unittest import mock

    from repro_torch.models import moe

    route = moe.route

    def spy(*args, **kwargs):
        out = route(*args, **kwargs)
        into.append(out[3])
        return out

    with mock.patch.object(moe, "route", spy):
        yield


def routing_flips(cfg, routes: dict):
    """Log, per MoE layer, how many top-k choices of the kernels' decode
    step differ from the plain versions' (as sets a token).  Returns a
    (B,) mask of the sequences whose choices agree in every layer, or
    None for a model without experts."""
    import torch

    if not cfg.n_experts:
        return None
    a_all, b_all = routes["kernel"], routes["plain"]
    if len(a_all) != len(b_all) or len(a_all) != cfg.n_layers:
        fail(f"{cfg.name}: {len(a_all)} / {len(b_all)} routed layers "
             f"recorded, {cfg.n_layers} expected")
    same = torch.ones(a_all[0].shape[0], dtype=torch.bool,
                      device=a_all[0].device)
    flips = []
    for a, b in zip(a_all, b_all):
        # a choice of one run that the other run did not make
        miss = (a[..., :, None] != b[..., None, :]).all(-1)
        flips.append(int(miss.sum()))
        same &= ~miss.flatten(1).any(-1)
    log(f"[serve] {cfg.name} top-{cfg.top_k} choices that differ between "
        f"the kernels' and the plain versions' first decode step, by layer: "
        f"{flips} (of {BATCH * cfg.top_k} a layer)")
    return same


def log_moe_bound(cfg, params) -> None:
    """A MoE model's decode bound: every step reads every expert's weights
    (the capacity dispatch computes each expert's slots, filled or not),
    so the step cannot take less than the weights over the HBM rate."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.moe import group_capacity

    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[serve] {cfg.name}: {nbytes / 2**30:.2f} GiB of weights read a "
        f"decode step, bound {nbytes / HBM_BYTES_PER_S * 1e3:.2f} ms a token "
        f"(3.35 TB/s); capacity {group_capacity(cfg, PROMPT_LEN)} slots an "
        f"expert in prefill, {group_capacity(cfg, 1)} in decode")


def _device_rows(prof) -> list:
    """``(name, device ms, calls)`` of every device activity in a finished
    trace, by summing the raw kineto events by name (user annotations
    left out), which skips the profiler's Python event tree (minutes for a
    train step's ~450k kernels)."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                and not e.is_user_annotation():
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    return [(k, ns / 1e6, n) for k, (ns, n) in by_name.items()]


def profile_window(name: str, fn):
    """``torch.profiler`` over one call of ``fn``, tracing the device
    alone: the ten device kernels with the most self time, then every
    kernel of the port's, and the device's idle share of the wall time
    (both under the profiler).  Returns the device's busy ms and its idle
    share, or (None, None) when the trace has no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(ms for _, ms, _ in rows)
    if not rows:
        log(f"[profile] {name}: no device time in the trace "
            "(device busy share not measured)")
        return None, None
    idle = 1 - busy_ms / wall_ms
    log(f"[profile] {name}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {idle:.3f}")
    rows.sort(key=lambda r: -r[1])
    # the top ten, then the port's own kernels below them
    for key, ms, count in rows[:10] + [r for r in rows[10:]
                                       if any(k in r[0] for k in KERNEL_META)]:
        log(f"[profile]   {ms:9.3f} ms {count:6d} calls  {key[:90]}")
    return busy_ms, idle


def profile_serve(res, steps: int = 4) -> dict:
    """Where the serve step's time goes: :func:`profile_window` over one
    prefill and over ``steps`` decode steps.  Returns each window's device
    busy ms and idle share."""
    import torch

    from repro_torch.parallel import Sharder

    model, params, shd = res["model"], res["params"], Sharder()
    max_len = PROMPT_LEN + NEW_TOKENS

    with torch.inference_mode():
        state = {}

        def prefill():
            state["logits"], state["cache"] = model.prefill(
                params, prefill_batch(res), shd, max_len=max_len)

        def decode():
            logits = state["logits"]
            for i in range(steps):
                logits, _ = model.decode_step(
                    params, state["cache"], step_batch(res, i, logits), shd)

        name = model.cfg.name
        out = {}
        for what, fn in (("prefill", prefill), (f"decode x{steps}", decode)):
            busy, idle = profile_window(f"{name} {what}", fn)
            key = what.split()[0]
            out[f"{key}_busy_ms"], out[f"{key}_idle"] = busy, idle
    return out


# Each architecture's full-width capture: (phase, kind) -> calls on a fake
# 4x2 ``cuda`` mesh.  A ``cuda`` mesh's shard-to-shard redistribution is
# DTensor's own ``_dtensor.shard_dim_alltoall`` (a CPU mesh issues
# all-gather + chunk instead): an interceptor that misses it drops every
# all-to-all here.  The cache is sequence-sharded (``kv_seq``): prefill
# reshards each layer's filled cache from kv heads to sequence shards (two
# all-to-alls a layer where kv heads divide ``model``), decode gathers q, k
# and v to all heads (three all-gathers a layer where they were
# head-sharded) and merges the shards' partials with two all-reduces a
# layer; a split head (MQA's one kv head) is gathered before its rotary
# embedding.
MONITOR_CALLS = {
    "qwen3_8b": {
        ("prefill", "all-to-all"): 290, ("prefill", "all-gather"): 109,
        ("prefill", "reduce-scatter"): 181, ("prefill", "all-reduce"): 73,
        ("decode", "all-to-all"): 218, ("decode", "all-gather"): 217,
        ("decode", "reduce-scatter"): 145, ("decode", "all-reduce"): 145,
    },
    "recurrentgemma_2b": {
        ("prefill", "all-to-all"): 124, ("prefill", "all-gather"): 111,
        ("prefill", "reduce-scatter"): 89, ("prefill", "all-reduce"): 71,
        ("decode", "all-to-all"): 140, ("decode", "all-gather"): 103,
        ("decode", "reduce-scatter"): 105, ("decode", "all-reduce"): 87,
    },
    # the transformer-backbone configs: MHA (CodeQwen), a vocab the model
    # axis does not divide (Granite-3-2B: whole logits, no vocab shards),
    # MQA's replicated kv head (Granite-20B), embeddings inputs (Chameleon,
    # MusicGen: no token lookup)
    "codeqwen15_7b": {
        ("prefill", "all-to-all"): 258, ("prefill", "all-gather"): 97,
        ("prefill", "reduce-scatter"): 193, ("prefill", "all-reduce"): 65,
        ("decode", "all-to-all"): 194, ("decode", "all-gather"): 193,
        ("decode", "reduce-scatter"): 129, ("decode", "all-reduce"): 129,
    },
    "granite_3_2b": {
        ("prefill", "all-to-all"): 242, ("prefill", "all-gather"): 202,
        ("prefill", "reduce-scatter"): 81, ("prefill", "all-reduce"): 80,
        ("decode", "all-to-all"): 242, ("decode", "all-gather"): 241,
        ("decode", "reduce-scatter"): 161, ("decode", "all-reduce"): 160,
    },
    "granite_20b": {
        ("prefill", "all-to-all"): 210, ("prefill", "all-gather"): 365,
        ("prefill", "reduce-scatter"): 105, ("prefill", "all-reduce"): 105,
        ("decode", "all-to-all"): 314, ("decode", "all-gather"): 313,
        ("decode", "reduce-scatter"): 209, ("decode", "all-reduce"): 209,
    },
    "chameleon_34b": {
        ("prefill", "all-to-all"): 385, ("prefill", "all-gather"): 144,
        ("prefill", "reduce-scatter"): 241, ("prefill", "all-reduce"): 96,
        ("decode", "all-to-all"): 289, ("decode", "all-gather"): 288,
        ("decode", "reduce-scatter"): 193, ("decode", "all-reduce"): 192,
    },
    "musicgen_medium": {
        ("prefill", "all-to-all"): 385, ("prefill", "all-gather"): 144,
        ("prefill", "reduce-scatter"): 289, ("prefill", "all-reduce"): 96,
        ("decode", "all-to-all"): 289, ("decode", "all-gather"): 288,
        ("decode", "reduce-scatter"): 193, ("decode", "all-reduce"): 192,
    },
    # xLSTM-1.3B at full depth (24 mLSTM/sLSTM superblocks, 4 heads over
    # model 2: two whole heads a rank): no attention and no kv cache; each
    # block's cell runs on local shards, its inputs resharded into it (the
    # all-to-alls), the decode step in the cache's layout (C split along
    # its v rows; q, k and n gathered whole, h gathered before the heads
    # merge)
    "xlstm_1_3b": {
        ("prefill", "all-to-all"): 194, ("prefill", "all-gather"): 217,
        ("prefill", "reduce-scatter"): 265, ("prefill", "all-reduce"): 73,
        ("decode", "all-to-all"): 194, ("decode", "all-gather"): 241,
        ("decode", "reduce-scatter"): 193, ("decode", "all-reduce"): 97,
    },
    # the MoE configs at full depth (64 and 48 layers; 8 and 128 experts
    # over model 2: EP): each block's local steps gather the router over
    # data and model and wi/wo over data, and all-reduce the experts'
    # shares over model (4 all-gathers and 1 all-reduce a layer beyond the
    # attention's); no all-to-all dispatches a token
    "grok_1_314b": {
        ("prefill", "all-to-all"): 386, ("prefill", "all-gather"): 321,
        ("prefill", "reduce-scatter"): 321, ("prefill", "all-reduce"): 129,
        ("decode", "all-to-all"): 258, ("decode", "all-gather"): 513,
        ("decode", "reduce-scatter"): 193, ("decode", "all-reduce"): 257,
    },
    "llama4_maverick_400b_a17b": {
        ("prefill", "all-to-all"): 290, ("prefill", "all-gather"): 241,
        ("prefill", "reduce-scatter"): 241, ("prefill", "all-reduce"): 97,
        ("decode", "all-to-all"): 194, ("decode", "all-gather"): 385,
        ("decode", "reduce-scatter"): 145, ("decode", "all-reduce"): 193,
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
    if calls != MONITOR_CALLS.get(arch):
        fail(f"{cfg.name} per-phase collective calls {calls} != expected "
             f"{MONITOR_CALLS.get(arch)}")
    save_and_reload(rep, arch)
    return rep


# Each architecture's full-width train step (the TRAIN preset's remat, one
# microbatch: every microbatch repeats the same collectives) on a fake 4x2
# ``cuda`` mesh, global batch 8 x 128 tokens: kind -> (calls, payload
# bytes).  FSDP all-gathers of the weights in the forward and again in the
# recomputed forward, reduce-scatters of their gradients, the all-to-alls of
# DTensor's shard-to-shard moves, one scalar all-reduce a sharded leaf
# for the gradient norm, and the all-reduces of the gradients of weights a
# local step reads whole on each batch shard (the norms, RecurrentGemma's
# conv: ``Sharder.local``'s gradient rule).  The token ids are gathered
# once, before the lookup, so the table's gradient comes out split by its
# columns as the table is: no reduce-scatter of it
TRAIN_MONITOR = {
    "qwen3_8b": {"all-gather": (400, 16428834816),
                 "all-reduce": (419, 1529348312),
                 "all-to-all": (617, 10351542272),
                 "reduce-scatter": (615, 47051177984)},
    "recurrentgemma_2b": {"all-gather": (344, 9567215616),
                          "all-reduce": (438, 1931948944),
                          "all-to-all": (305, 3198156800),
                          "reduce-scatter": (431, 18465423360)},
}


def run_train_monitor(arch: str):
    """Phase 5's train capture of one architecture at its published width
    and depth (``launch.train.monitor``), held to :data:`TRAIN_MONITOR`,
    saved and reloaded.  Returns the report."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch

    cfg = launch_serve.model_config(arch)
    tcfg = dataclasses.replace(configs.train_config(arch), microbatches=1)
    t0 = time.perf_counter()
    rep = launch.monitor(cfg, ocfg=launch.opt_config(LM_LR, TRAIN_STEPS),
                         tcfg=tcfg, mesh_shape=(4, 2), global_batch=BATCH,
                         seq_len=PROMPT_LEN, device="cuda")
    kinds = {k: (r["calls"], r["payload_bytes"])
             for k, r in rep.compiled_summary.items()}
    log(f"[monitor] {cfg.name} {cfg.n_layers}L train step ({BATCH} x "
        f"{PROMPT_LEN} tokens, remat {tcfg.remat}) on a fake 4x2 mesh: "
        f"{len(rep.compiled_ops)} collectives captured in "
        f"{time.perf_counter() - t0:.3f} s; by kind {kinds}")
    if kinds != TRAIN_MONITOR.get(arch):
        fail(f"{cfg.name} train capture {kinds} != expected "
             f"{TRAIN_MONITOR.get(arch)}")
    save_and_reload(rep, f"train_{arch}")
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


# ---------------------------------------------------------------------------
# the lm-train phase
# ---------------------------------------------------------------------------
def expected_train_launches(cfg, tcfg) -> dict:
    """Kernel launches of one train step of ``cfg`` under ``tcfg``: per
    microbatch, then times the microbatches.  A layer checkpointed by the
    remat policy runs its forward again in the backward, launching its
    kernels again: the transformer's layers unless ``remat == "none"``,
    GriffinLM's superblocks always (the reference's ``dots``), never its
    tail layers or the final norm.  Two RMSNorms a layer (norm1, norm2),
    two more an attention layer with qk-norm, one flash attention an
    attention layer, one RG-LRU scan a recurrent layer, and the final
    norm.  Of the backwards RG-LRU's and flash attention's are kernels:
    one call a recurrent or attention layer (the recomputed forward's; the
    first forward of a checkpointed layer keeps no graph)."""
    a = max(1, tcfg.microbatches)
    qk = 2 if cfg.qk_norm else 0
    if cfg.family == "hybrid":
        ns = cfg.n_layers // 3
        nt = cfg.n_layers - 3 * ns
        norms = 2 * ns * (6 + qk) + 2 * nt + 1
        counts = {"rmsnorm": norms, "flash_attention": 2 * ns,
                  "rglru": 2 * 2 * ns + nt, "rglru_bwd": 2 * ns + nt,
                  "flash_attention_bwd": ns}
    else:
        r = 1 if tcfg.remat == "none" else 2
        counts = {"rmsnorm": r * cfg.n_layers * (2 + qk) + 1,
                  "flash_attention": r * cfg.n_layers, "rglru": 0,
                  "rglru_bwd": 0, "flash_attention_bwd": cfg.n_layers}
    return dict({k: a * v for k, v in counts.items()}, flash_decode=0,
                flash_decode_partial=0)


def lm_train_flops(model, tcfg) -> float:
    """FLOPs of one train step at the phase's traffic, counted by
    ``repro_torch.core.op_cost`` on one microbatch (one sequence, the
    update included) under ``FakeTensorMode``, times the microbatches:
    forward, recomputed forward and backward, each kernel op by its
    formula (flash attention as full score blocks)."""
    import dataclasses

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.op_cost import OpCostMode
    from repro_torch.optim import OptConfig
    from repro_torch.parallel import Sharder
    from repro_torch.train.train import make_train_step, train_state_shapes

    one = dataclasses.replace(tcfg, microbatches=1)
    with FakeTensorMode():
        state = train_state_shapes(model, OptConfig(), device="cuda")
        batch = {k: torch.zeros((1, LM_SEQ), dtype=torch.int32,
                                device="cuda") for k in ("tokens", "labels")}
        step = make_train_step(model, OptConfig(), one, Sharder())
        with OpCostMode() as oc:
            step(state, batch)
    return oc.cost()["flops"] * max(1, tcfg.microbatches)


def timed_backwards(fn) -> tuple:
    """One call of ``fn`` (a train step) with a CUDA event pair around
    every call of the attention and the RG-LRU backward kernels' wrappers
    (each module's ``_launch_bwd``) inside it.
    Returns the step's wall ms (host clock, ending in a synchronize) and,
    by backward, its calls and the device ms between its events, summed:
    the time each backward held the stream in this step, the gaps the host
    left in it included."""
    from unittest import mock

    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import ops as rg_ops

    spans = {BWD_NAMES["attention"]: [], BWD_NAMES["rglru"]: []}

    def timed(name, bwd):
        def call(*args, **kwargs):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = bwd(*args, **kwargs)
            pair[1].record()
            spans[name].append(pair)
            return out
        return call

    torch.cuda.synchronize()
    with mock.patch.object(fa_ops, "_launch_bwd",
                           timed(BWD_NAMES["attention"],
                                 fa_ops._launch_bwd)), \
            mock.patch.object(rg_ops, "_launch_bwd",
                              timed(BWD_NAMES["rglru"], rg_ops._launch_bwd)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, {name: (len(pairs), sum(s.elapsed_time(e)
                                            for s, e in pairs))
                     for name, pairs in spans.items()}


# what each backward timed inside a step is
BWD_NAMES = {"attention": "attention backward kernels",
             "rglru": "rglru backward kernel"}


def run_lm_train(arch: str) -> dict:
    """The lm-train phase for one architecture at its published width:
    ``launch.train.train`` for TRAIN_STEPS steps of the TRAIN preset on the
    card, the launch counters zeroed just before and read just after (they
    must be TRAIN_STEPS x ``expected_train_launches``); the losses finite
    and falling.  Then, from the same start (seed 0 on the card), the first
    step with each kernel launch replaced by its plain version, held
    against the kernels' first step;
    that state's next step under torch.profiler; the backwards' share of
    the step after it (attention's and RG-LRU's kernels), timed inside it;
    the step's bf16 FLOP bound.  Returns the
    launch counts and the numbers for the JSON line."""
    from unittest import mock

    import torch

    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_from_lse, attention_lse, attention_ref)
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel import Sharder
    from repro_torch.train import init_train_state, make_train_step

    cfg = launch_serve.model_config(arch, LM_ARCHS[arch])
    tcfg = configs.train_config(arch)
    ocfg = launch.opt_config(LM_LR, TRAIN_STEPS)
    secs, t0 = {}, time.perf_counter()
    zero_counts()
    res = launch.train(cfg, steps=TRAIN_STEPS, global_batch=LM_BATCH,
                       seq_len=LM_SEQ, ocfg=ocfg, tcfg=tcfg, device="cuda",
                       log=log)
    torch.cuda.synchronize()
    counts = read_counts()
    secs["train"] = time.perf_counter() - t0
    expect = {k: TRAIN_STEPS * v
              for k, v in expected_train_launches(cfg, tcfg).items()}
    n_params = sum(p.numel() for p in tree_leaves(res["state"]["params"]))
    losses, gnorms = res["losses"], res["grad_norms"]
    log(f"[lm-train] {cfg.name} d{cfg.d_model} {cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters, {TRAIN_STEPS} steps of "
        f"{LM_BATCH} x {LM_SEQ} tokens ({tcfg.microbatches} microbatches, "
        f"remat {tcfg.remat}): median step {res['median_step_ms']:.1f} ms "
        f"(steps 2-{TRAIN_STEPS}) | {res['tokens_per_s']:.1f} tokens/s | "
        f"max memory {res['max_memory_bytes'] / 2**30:.2f} GiB")
    log(f"[lm-train] {cfg.name} losses {[round(v, 4) for v in losses]}; "
        f"grad_norm {[round(v, 3) for v in gnorms]}; step ms "
        f"{[round(v, 1) for v in res['step_ms']]}")
    log(f"[lm-train] {cfg.name} kernel launches of {TRAIN_STEPS} steps "
        f"{counts} (expected {expect})")
    if counts != expect:
        fail(f"{cfg.name} train launch counts {counts} != expected {expect}")
    if not all(math.isfinite(v) for v in losses + gnorms):
        fail(f"{cfg.name}: non-finite loss or grad norm {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"{cfg.name} did not learn: loss {losses[0]} -> {losses[-1]}")
    model = res["model"]
    out = {"counts": counts, "median_step_ms": res["median_step_ms"],
           "tokens_per_s": res["tokens_per_s"],
           "max_memory_gib": res["max_memory_bytes"] / 2**30,
           "losses": losses}
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # the first step again from the same start, each kernel launch replaced
    # by its plain version: the backward kernels by rglru_bwd and
    # attention_bwd_from_lse, their arithmetic in plain PyTorch (a custom
    # op's implementation runs below autograd, so autograd through
    # attention_ref cannot run there; the other ops' backward formulas are
    # the same ones)
    t0 = time.perf_counter()
    state = init_train_state(model, ocfg, 0, device="cuda")
    step = make_train_step(model, ocfg, tcfg, Sharder())
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                           global_batch=LM_BATCH, seed=0)
    with mock.patch.object(rn_ops, "_launch", lambda x, w, eps, plan=None:
                           rmsnorm_ref(x, w, eps)), \
            mock.patch.object(fa_ops, "_launch_lse", lambda q, k, v, c, w, o:
                              (attention_ref(q, k, v, causal=c, window=w,
                                             q_offset=o),
                               attention_lse(q, k, causal=c, window=w,
                                             q_offset=o))), \
            mock.patch.object(fa_ops, "_launch_bwd",
                              lambda do, q, k, v, out, lse, c, w, o:
                              attention_bwd_from_lse(do, q, k, v, out, lse,
                                                     causal=c, window=w,
                                                     q_offset=o)), \
            mock.patch.object(rg_ops, "_launch", rglru_ref), \
            mock.patch.object(rg_ops, "_launch_bwd", rg_ops._plain_bwd):
        _, met = step(state, data.batch_at(0, "cuda"))
    loss, gnorm = float(met["loss"]), float(met["grad_norm"])
    # bf16 compute through every layer: each kernel's fp32 sums may flip a
    # bf16 rounding the plain version made the other way, compounding over
    # depth.  Measured on an H100 80GB HBM3 at 700 W: 1.7e-6 to 8.3e-6 of
    # the loss and 3.3e-6 to 7.1e-6 of the gradient norm; 1e-4 of each is
    # about ten times the largest, tight enough that a fault in a few
    # layers' kernels shows
    l_err, g_err = abs(loss - losses[0]), abs(gnorm - gnorms[0])
    log(f"[lm-train] {cfg.name} first step against the plain versions: "
        f"loss {losses[0]:.6f} vs {loss:.6f} (err {l_err:.2e}, tol "
        f"{1e-4 * loss:.2e} = 1e-4 of it), grad_norm {gnorms[0]:.5f} vs "
        f"{gnorm:.5f} (err {g_err:.2e}, tol {1e-4 * gnorm:.2e} = 1e-4 of "
        "it)")
    if not (l_err <= 1e-4 * loss and g_err <= 1e-4 * gnorm):
        fail(f"{cfg.name}: the first train step differs from the plain "
             "versions'")

    # where one step's time goes; the backwards' share; the bound
    secs["plain step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = data.batch_at(1, "cuda")
    busy, _ = profile_window(f"{cfg.name} train step",
                             lambda: step(state, batch))
    secs["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = data.batch_at(2, "cuda")
    bwd_step_ms, bwd = timed_backwards(lambda: step(state, batch))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    # each attention and recurrent layer's backward once a microbatch
    a = max(1, tcfg.microbatches)
    n_attn = a * (cfg.n_layers // 3 if cfg.family == "hybrid"
                  else cfg.n_layers)
    want = {BWD_NAMES["attention"]: n_attn,
            BWD_NAMES["rglru"]: a * cfg.n_layers - n_attn
            if cfg.family == "hybrid" else 0}
    calls = {k: n for k, (n, _) in bwd.items()}
    if calls != want:
        fail(f"{cfg.name}: backward calls in one step {calls} != {want}")
    share = {k: ms / bwd_step_ms for k, (n, ms) in bwd.items() if n}
    log(f"[lm-train] {cfg.name} backwards inside one step of "
        f"{bwd_step_ms:.1f} ms (CUDA events around each call): "
        + "; ".join(f"{k} {n} calls, {ms:.1f} ms ({ms / n:.3f} a call) = "
                    f"{share[k]:.4f} of the step"
                    for k, (n, ms) in bwd.items() if n))
    secs["backwards"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flops = lm_train_flops(model, tcfg)
    secs["FLOP count"] = time.perf_counter() - t0
    b_ms = flops / BF16_FLOPS * 1e3
    log(f"[lm-train] {cfg.name} one step: {flops / 1e12:.3f} TFLOP "
        f"(op_cost, with recompute), bf16 bound {b_ms:.1f} ms at 989 "
        f"TFLOP/s = {b_ms / out['median_step_ms']:.3f} of the median step")
    log(f"[lm-train] {cfg.name} seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return dict(out, busy_ms=busy, bwd_step_ms=bwd_step_ms,
                bwd_ms={k: ms for k, (n, ms) in bwd.items() if n},
                bwd_share=share, tflop=flops / 1e12, bound_ms=b_ms)


def run_lm_reduced(arch: str) -> None:
    """The reduced config of ``arch`` on the card against the CPU, fp32
    compute, TF32 off: two steps of the TRAIN preset (8 x 64 tokens) from
    the same start (drawn on the CPU), the parameters held element by
    element to 1e-5 x max(1, |p|).  Then, on the card, four steps straight
    against two steps, a checkpoint, a resume and two more: the resumed
    losses within 1e-4 of the straight run's (relative)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.train import init_train_state

    cfg = dataclasses.replace(launch_serve.model_config(arch, reduced=True),
                              compute_dtype="float32")
    tcfg = configs.train_config(arch)
    # eps 1e-3: Adam's first steps move each weight by ~lr x sign(g), so a
    # gradient within rounding of zero could step either way on either
    # device; a larger eps makes the update continuous in the gradient
    ocfg = dataclasses.replace(launch.opt_config(LM_LR, TRAIN_STEPS),
                               eps=1e-3)
    start = init_train_state(build_model(cfg), ocfg, 0, device="cpu")

    def on(device):
        return tree_unflatten(start, [t.clone().to(device)
                                      for t in tree_leaves(start)])

    kw = dict(global_batch=LM_BATCH, seq_len=64, ocfg=ocfg, tcfg=tcfg,
              log=lambda m: None)
    card = launch.train(cfg, steps=2, device="cuda", state=on("cuda"), **kw)
    cpu = launch.train(cfg, steps=2, device="cpu", state=on("cpu"), **kw)
    worst = 0.0
    for g, c in zip(tree_leaves(card["state"]["params"]),
                    tree_leaves(cpu["state"]["params"])):
        worst = max(worst, ((g.cpu() - c).abs()
                            / c.abs().clamp_min(1.0)).max().item())
    log(f"[lm-train] {cfg.name} 2 steps, card against CPU (fp32): "
        f"parameters max |diff| / max(1, |p|) {worst:.3e} (tol 1e-5); "
        f"losses card {[round(v, 6) for v in card['losses']]} CPU "
        f"{[round(v, 6) for v in cpu['losses']]}")
    if not worst <= 1e-5:
        fail(f"{cfg.name}: two train steps on the card differ from the CPU's")

    ckpt = ROOT / "build" / "lm_ckpt" / arch
    shutil.rmtree(ckpt, ignore_errors=True)
    straight = launch.train(cfg, steps=4, device="cuda", state=on("cuda"),
                            **kw)
    launch.train(cfg, steps=2, device="cuda", state=on("cuda"),
                 ckpt_dir=str(ckpt), ckpt_every=2, **kw)
    resumed = launch.train(cfg, steps=4, device="cuda", ckpt_dir=str(ckpt),
                           ckpt_every=2, resume=True, **kw)
    want, got = straight["losses"][2:], resumed["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    # fp32 on the card is not bitwise run to run (the embedding backward
    # adds with atomics): 1e-4 of the loss bounds that noise after a step
    log(f"[lm-train] {cfg.name} resume at step {resumed['start']}: losses "
        f"{[round(v, 6) for v in got]} against the straight run's "
        f"{[round(v, 6) for v in want]} (max rel err {err:.2e}, tol 1e-4)")
    if resumed["start"] != 2 or len(got) != 2 or not err <= 1e-4:
        fail(f"{cfg.name}: the resumed run differs from the straight one")


# ---------------------------------------------------------------------------
# the examples phase
# ---------------------------------------------------------------------------
def load_example(name: str):
    """``examples/torch_<name>.py`` of the checkout, as a module."""
    import importlib.util

    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_examples() -> tuple[dict, dict]:
    """The user examples on the card, each through its ``main(argv)`` in
    this process (``EXAMPLE_RUNS``; an example's own assertion fails the
    run), then the quickstart through ``python -m repro_torch monitor``.
    The training examples open and destroy a one-rank NCCL group, so they
    run before the first fake group (translation's capture) is made.
    torch_serve_lm's launches, the counters zeroed just before its
    ``main`` and read just after, must be ``expected_launches`` of its
    warm-up generate and its timed one.  Returns each example's numbers
    and the serve example's launch counts."""
    from repro_torch.launch.serve import WARMUP_TOKENS, model_config

    out, counts = {}, None
    for name, argv in EXAMPLE_RUNS:
        example = load_example(name)
        if name == "serve_lm":
            zero_counts()
        t0 = time.perf_counter()
        res = example.main([*argv, "--device", "cuda"])
        wall = time.perf_counter() - t0
        if name == "serve_lm":
            counts = read_counts()
        row = {"wall_s": wall}
        if name == "image_classification":
            row.update(median_step_ms=res["median_step_ms"], acc=res["acc"],
                       loss=res["losses"][-1],
                       allreduces_per_step=res["allreduce_calls"])
            log(f"[examples] torch_image_classification {' '.join(argv)}: "
                f"{wall:.1f} s | median step {res['median_step_ms']:.2f} ms | final "
                f"acc {res['acc']:.2f}, loss {res['losses'][-1]:.4f} | "
                f"{res['allreduce_calls']} all-reduces a step")
        elif name == "translation":
            rep = res["report"]
            calls = {ph: sum(op.kind == "all-reduce" for op in rep.compiled_ops
                             if op.phase == ph) for ph in rep.phase_names()}
            row.update(median_step_ms=res["median_step_ms"],
                       loss=res["losses"][-1], first_loss=res["losses"][0],
                       allreduces_by_phase=calls)
            log(f"[examples] torch_translation: {wall:.1f} s | median step "
                f"{res['median_step_ms']:.2f} ms | loss "
                f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f} | "
                f"all-reduces a step by phase {calls}")
        else:
            row.update(tokens_per_s=res["tokens_per_s"],
                       prefill_ms=res["prefill_ms"],
                       decode_ms_per_token=res["decode_ms_per_token"])
            log(f"[examples] torch_serve_lm: {wall:.1f} s | "
                f"{res['tokens_per_s']:.1f} tok/s | prefill "
                f"{res['prefill_ms']:.2f} ms, decode "
                f"{res['decode_ms_per_token']:.2f} ms/token")
        out[name] = row
        del res
        gc.collect()
    cfg = model_config("qwen3_8b", reduced=True)
    warm, timed = (expected_launches(cfg, WARMUP_TOKENS - 1),
                   expected_launches(cfg, EX_TOKENS - 1))
    want = {k: warm[k] + timed[k] for k in warm}
    log(f"[examples] torch_serve_lm launches {counts} (expected {want})")
    if counts != want:
        fail(f"torch_serve_lm: launches {counts}, expected {want}")

    t0 = time.perf_counter()
    text = cli("monitor", "examples/torch_quickstart.py")
    wall = time.perf_counter() - t0
    line = next((ln for ln in text.splitlines()
                 if ln.startswith("roofline: compute")), None)
    log(f"[examples] python -m repro_torch monitor "
        f"examples/torch_quickstart.py: {wall:.1f} s | {line}")
    if line is None or "dominant=" not in text:
        fail("the quickstart printed no roofline")
    out["quickstart"] = {"wall_s": wall}
    return out, counts


# Phase 7's lint findings of every phase-5 capture, rule -> count.  A
# ``cuda`` mesh's shard-to-shard redistribution is one all-to-all, which no
# rule flags; GNMT's startup Broadcast is an all-gather of 8 copies of
# which the program keeps rank 0's (``sweep.broadcast_params``), one
# ``allgather-then-slice`` a gathered parameter (16 of its 17 all-gathers;
# the 17th, the metrics gather, keeps every rank's loss)
LINT_COUNTS = {
    "qwen3_8b": {"small-ar-bucketing": 36},
    "recurrentgemma_2b": {"small-ar-bucketing": 8},
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


def count_prefill(res) -> dict:
    """Phase 3's served Qwen3-8B prefill counted by
    ``repro_torch.core.op_cost`` twice: live on the card (the kernels run),
    and the same call on fake copies of its parameters and prompts under
    ``FakeTensorMode``.  Returns both counts."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    from repro_torch.core.op_cost import OpCostMode
    from repro_torch.parallel import Sharder

    model, params, shd = res["model"], res["params"], Sharder()
    batch = {"tokens": res["prompts"]}
    max_len = PROMPT_LEN + NEW_TOKENS
    with torch.inference_mode(), OpCostMode() as live:
        model.prefill(params, batch, shd, max_len=max_len)
    torch.cuda.synchronize()
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fake_params, fake_batch = tree_map(fm.from_tensor, (params, batch))
        with torch.inference_mode(), OpCostMode() as fake:
            model.prefill(fake_params, fake_batch, shd, max_len=max_len)
    log(f"[cost] {model.cfg.name} prefill ({BATCH} x {PROMPT_LEN} tokens) "
        f"counted live on the card {live.cost()}, under FakeTensorMode "
        f"{fake.cost()}")
    return {"live": live.cost(), "fake": fake.cost()}


# ---------------------------------------------------------------------------
# phase 8: the command line on the card
# ---------------------------------------------------------------------------
CLI_DEVICE = "cuda"
CLI_CONFIGS = ("paper", "gnmt", "resnet", "serve", "moe-skew", "grok_1_314b",
               "llama4_maverick_400b_a17b", "codeqwen15_7b", "granite_3_2b",
               "qwen3_8b", "granite_20b", "xlstm_1_3b", "chameleon_34b",
               "musicgen_medium", "recurrentgemma_2b")
CLI_MESHES = ("4x2", "2x2x2")
CLI_ALGORITHMS = ("ring", "hierarchical")
# the reference's summary and scale CSV headers (repro.core.export.
# csv_exporter), held as constants: this script imports nothing of it
SUMMARY_HEADER = ("config,mesh,algorithm,num_devices,primitive,calls,"
                  "payload_bytes,wire_bytes")
SCALE_HEADER = ("config,algorithm,devices,pods,ops,wire_bytes,ici_ms,dcn_ms,"
                "overlap_ms,bottleneck_link,bottleneck_ms,nnz,build_ms")
# each sweep cell's calls by kind, ring binding, on fake ``cuda`` meshes:
# (config, mesh) -> {kind: calls}.  The paper applications issue plain
# collectives on their replica group (no DTensor), as on a CPU mesh
# (tests/test_torch_sweep_run.py); the serve cell's DTensor reshards by
# all-to-all on a ``cuda`` mesh where a CPU mesh all-gathers and chunks.
# A train cell's scalar all-reduces on 2x2x2 depend on what the sweep's
# process captured before it (DTensor caches its sharding decisions): these
# are the counts of this sweep's order; the five transformer-backbone cells
# swept alone in a fresh process read two more each.  Every train cell
# all-reduces the gradients of the weights its local steps read whole on
# each batch shard (the norms: ``Sharder.local``'s gradient rule), and
# gathers the token ids once, before the lookup (``layers._gather_ids``):
# one all-gather and one reduce-scatter fewer than DTensor's own lookup
CLI_SWEEP_CALLS = {
    ("paper", "4x2"): {"all-reduce": 4},
    ("paper", "2x2x2"): {"all-reduce": 4},
    ("gnmt", "4x2"): {"all-gather": 17, "all-reduce": 8},
    ("gnmt", "2x2x2"): {"all-gather": 17, "all-reduce": 8},
    ("resnet", "4x2"): {"all-reduce": 17},
    ("resnet", "2x2x2"): {"all-reduce": 17},
    ("serve", "4x2"): {"all-gather": 54, "all-reduce": 26, "all-to-all": 36,
                       "reduce-scatter": 18},
    ("serve", "2x2x2"): {"all-gather": 66, "all-reduce": 26, "all-to-all": 24,
                         "reduce-scatter": 6},
    ("qwen3_8b", "4x2"): {"all-gather": 70, "all-reduce": 67, "all-to-all": 2,
                          "reduce-scatter": 25},
    ("qwen3_8b", "2x2x2"): {"all-gather": 70, "all-reduce": 101,
                            "all-to-all": 2, "reduce-scatter": 25},
    ("recurrentgemma_2b", "4x2"): {"all-gather": 114, "all-reduce": 131,
                                   "all-to-all": 2, "reduce-scatter": 49},
    ("recurrentgemma_2b", "2x2x2"): {"all-gather": 114, "all-reduce": 165,
                                     "all-to-all": 2, "reduce-scatter": 49},
    ("codeqwen15_7b", "4x2"): {"all-gather": 70, "all-reduce": 51,
                               "all-to-all": 2, "reduce-scatter": 25},
    ("codeqwen15_7b", "2x2x2"): {"all-gather": 70, "all-reduce": 77,
                                 "all-to-all": 2, "reduce-scatter": 25},
    ("granite_3_2b", "4x2"): {"all-gather": 70, "all-reduce": 51,
                              "all-to-all": 2, "reduce-scatter": 25},
    ("granite_3_2b", "2x2x2"): {"all-gather": 70, "all-reduce": 77,
                                "all-to-all": 2, "reduce-scatter": 25},
    ("granite_20b", "4x2"): {"all-gather": 94, "all-reduce": 51,
                             "all-to-all": 2, "reduce-scatter": 25},
    ("granite_20b", "2x2x2"): {"all-gather": 94, "all-reduce": 77,
                               "all-to-all": 2, "reduce-scatter": 25},
    ("chameleon_34b", "4x2"): {"all-gather": 69, "all-reduce": 66,
                               "reduce-scatter": 25},
    ("chameleon_34b", "2x2x2"): {"all-gather": 69, "all-reduce": 99,
                                 "reduce-scatter": 25},
    ("musicgen_medium", "4x2"): {"all-gather": 69, "all-reduce": 50,
                                 "reduce-scatter": 25},
    ("musicgen_medium", "2x2x2"): {"all-gather": 69, "all-reduce": 75,
                                   "reduce-scatter": 25},
    # the hot expert's dispatch and combine, one all_to_all_single each
    ("moe-skew", "4x2"): {"all-to-all": 2},
    ("moe-skew", "2x2x2"): {"all-to-all": 2},
    # the reduced MoE train cells (4 experts over model 2): the weight
    # gathers of each block's local steps and, in the backward, the
    # gradients the batch and expert shards share, reduced
    ("grok_1_314b", "4x2"): {"all-gather": 70, "all-reduce": 69,
                             "all-to-all": 2, "reduce-scatter": 33},
    ("grok_1_314b", "2x2x2"): {"all-gather": 70, "all-reduce": 107,
                               "all-to-all": 2, "reduce-scatter": 33},
    ("llama4_maverick_400b_a17b", "4x2"): {"all-gather": 70, "all-reduce": 69,
                                           "all-to-all": 2,
                                           "reduce-scatter": 33},
    ("llama4_maverick_400b_a17b", "2x2x2"): {"all-gather": 70,
                                             "all-reduce": 107,
                                             "all-to-all": 2,
                                             "reduce-scatter": 33},
    # the reduced xLSTM train cell: each block's cell on local shards
    # (two whole heads a rank on model 2), the sLSTM's r_g gathered to
    # them, one op a layer for each loop
    ("xlstm_1_3b", "4x2"): {"all-gather": 78, "all-reduce": 88,
                            "all-to-all": 8, "reduce-scatter": 35},
    ("xlstm_1_3b", "2x2x2"): {"all-gather": 78, "all-reduce": 104,
                              "all-to-all": 8, "reduce-scatter": 35},
}
# the scale curve's fleet sizes: the all-to-alls of a cuda capture hold
# 1.0 M COO entries at 4096 devices and 4.2 M at 16384, which the
# per-entry ``project_links`` routes in minutes (ROADMAP queue 1 item 7)
CLI_SCALE_POINTS = "256,1024"


def cli(*args: str, expect: int = 0) -> str:
    """``python -m repro_torch *args`` in a subprocess from the checkout;
    fails the run unless it exits with ``expect``.  Returns its stdout."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True)
    log(f"[cli] python -m repro_torch {' '.join(args)}: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.2f} s")
    if proc.returncode != expect:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        fail(f"`python -m repro_torch {' '.join(args)}` exited "
             f"{proc.returncode}, expected {expect}")
    return proc.stdout


# the dry run's cells under ``--sp --tag sp`` (the Sharder's ``seq ->
# model`` rule), each in a process of its own on the single pod
SP_CELLS = (("qwen3_8b", "prefill_32k"), ("qwen3_8b", "train_4k"),
            ("recurrentgemma_2b", "prefill_32k"),
            ("xlstm_1_3b", "prefill_32k"))


# the dry-run phase: ``python -m repro_torch dryrun`` invocations, run side
# by side (each its own fake process group of 256 or 512 ``cuda`` ranks),
# (archs, shape, mesh, sp): every ported architecture's decode_32k on both
# production meshes, the two long-context architectures' long_500k
# (xLSTM-1.3B and RecurrentGemma-2B, through ``--mesh both``), Qwen3-8B's
# prefill_32k and train_4k on the single pod, and :data:`SP_CELLS`
def dryrun_runs() -> tuple:
    from repro_torch import configs

    # the MoE configs' decode cells in processes of their own (Grok-1's 64
    # layers and Llama-4's 48 trace longest), beside the others'
    dense = tuple(a for a in configs.ARCH_IDS if a not in MOE_ARCHS)
    moe = tuple(a for a in configs.ARCH_IDS if a in MOE_ARCHS)
    return ((moe, "decode_32k", "single", False),
            (moe, "decode_32k", "multi", False),
            (dense, "decode_32k", "single", False),
            (dense, "decode_32k", "multi", False),
            (configs.LONG_CONTEXT_ARCHS, "long_500k", "both", False),
            (("qwen3_8b",), "prefill_32k", "single", False),
            (("qwen3_8b",), "train_4k", "single", False)) + tuple(
        ((arch,), shape, "single", True) for arch, shape in SP_CELLS)


def run_dryrun() -> dict:
    """The dry-run phase: each of :func:`dryrun_runs` as ``python -m
    repro_torch dryrun`` in its own process, all started together, writing
    under ``build/dryrun``.  Every cell must be ``ok``; a decode cell's
    cache bytes per device (its ``alias_bytes``: the cache the step updates
    in place) must equal ``dryrun.cache_bytes_per_device``; each cell's
    trace seconds and ``memory.total_bytes`` are printed, and an ``--sp``
    cell's collectives by kind beside those of its cell without ``--sp``
    where there is one.  Returns ``{"arch shape mesh[ sp]": (trace_s,
    total_bytes, alias_bytes, {kind: [calls, payload bytes]})}``."""
    import os

    from repro_torch import configs
    from repro_torch.launch.dryrun import cache_bytes_per_device
    from repro_torch.launch.mesh import production_layout
    from repro_torch.models.common import SHAPES_BY_NAME

    out = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    t0 = time.perf_counter()
    for archs, shape, mesh, sp in dryrun_runs():
        args = ["dryrun", "--arch", ",".join(archs), "--shape", shape,
                "--mesh", mesh, "--out", str(out)] + (
                    ["--sp", "--tag", "sp"] if sp else [])
        procs.append((args, subprocess.Popen(
            [sys.executable, "-m", "repro_torch", *args], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for args, proc in procs:
        text, _ = proc.communicate()
        log(f"[dryrun] python -m repro_torch {' '.join(args)}: exit "
            f"{proc.returncode} at {time.perf_counter() - t0:.1f} s")
        for line in text.splitlines():
            if line.startswith(("[dryrun]", "  ok:", "  FAIL", "meshes")):
                log(f"[dryrun]   {line.strip()}")
        if proc.returncode != 0:
            log(text[-6000:])
            fail(f"`python -m repro_torch {' '.join(args)}` exited "
                 f"{proc.returncode}")
    cells = {}
    for arch, shape, mesh, sp in (
            (a, shape, m, sp) for archs, shape, mesh, sp in dryrun_runs()
            for a in archs
            for m in (("single", "multi") if mesh == "both" else (mesh,))):
        key = f"{arch} {shape} {mesh}" + (" sp" if sp else "")
        r = json.loads((out / (f"{arch}_{shape}_{mesh}" + (
            "_sp" if sp else "") + ".json")).read_text())
        mem = r["memory"]
        log(f"[dryrun] {key} ({r['devices']} ranks): ok "
            f"{r['ok']}, trace {r['trace_s']:.2f} s, total "
            f"{mem['total_bytes'] / 1e9:.3f} GB a device (arguments "
            f"{mem['argument_bytes'] / 1e9:.3f}, temp "
            f"{mem['temp_bytes'] / 1e9:.3f}, updated in place "
            f"{mem['alias_bytes'] / 1e9:.4f})"
            f", dominant {r['roofline']['dominant']}")
        if not r["ok"]:
            fail(f"dry run {key} not ok")
        if SHAPES_BY_NAME[shape].kind == "decode":
            want = cache_bytes_per_device(
                configs.config(arch), SHAPES_BY_NAME[shape],
                *production_layout(mesh == "multi"))
            if mem["alias_bytes"] != want:
                fail(f"dry run {arch} {shape} {mesh}: cache "
                     f"{mem['alias_bytes']} B a device != {want}")
        cells[key] = (r["trace_s"], mem["total_bytes"], mem["alias_bytes"],
                      {k: [v["calls"], v["payload_bytes"]]
                       for k, v in sorted(r["collectives"].items())})
    for key, (trace_s, total, _, kinds) in cells.items():
        if not key.endswith(" sp"):
            continue
        base = cells.get(key[:-3])
        log(f"[dryrun] {key}: trace {trace_s:.2f} s, total "
            f"{total / 1e9:.3f} GB a device" + (
                f" (without --sp: trace {base[0]:.2f} s, total "
                f"{base[1] / 1e9:.3f} GB)" if base else ""))
        for kind in sorted(set(kinds) | set(base[3] if base else ())):
            calls, nbytes = kinds.get(kind, (0, 0))
            log(f"[dryrun]   {kind}: {calls} calls, {nbytes} B" + (
                " (without --sp: {} calls, {} B)".format(
                    *base[3].get(kind, (0, 0))) if base else ""))
    return cells


def _sweep_counts(out: str) -> tuple[int, int, int]:
    """(cells, captured, cache hits) of a sweep's summary line."""
    import re

    m = re.search(r"== sweep summary: (\d+) cells \((\d+) captured, "
                  r"(\d+) cache hits\) ==", out)
    if m is None:
        fail("no sweep summary line in the sweep's output")
    return tuple(int(g) for g in m.groups())


def run_cli(captures: dict, traces: dict, prefill: dict) -> None:
    """Phase 8: the port's command line, ``python -m repro_torch``, on the
    card: configs, a cold and a warm sweep, a config monitored into every
    export format, lint exit codes, ``compare`` on phase 7's live trace,
    a scale curve, then the roofline of phase 5's full-width captures and
    the H100 bound of phase 3's counted prefill."""
    import csv
    import shutil

    from repro_torch.core import export, roofline_of
    from repro_torch.core.report_cache import ReportCache
    from repro_torch.core.roofline import to_row

    out = ROOT / "build" / "cli"
    shutil.rmtree(out, ignore_errors=True)
    cache = ["--cache-dir", str(out / "cache")]
    dev = ["--device", CLI_DEVICE]

    listed = [line.split("|")[0].strip()
              for line in cli("configs").splitlines()[2:] if "|" in line]
    log(f"[cli] configs: {listed}")
    if sorted(listed) != sorted(CLI_CONFIGS):
        fail(f"configs lists {listed}, expected {list(CLI_CONFIGS)}")

    sweep = ["sweep", "--configs", ",".join(CLI_CONFIGS), "--meshes",
             ",".join(CLI_MESHES), "--algorithms", ",".join(CLI_ALGORITHMS),
             "--by-phase", "--lint", *dev, *cache]
    n_cells = len(CLI_CONFIGS) * len(CLI_MESHES) * len(CLI_ALGORITHMS)
    timed = {}
    for run, want in (("cold", (n_cells, len(CLI_CONFIGS) * len(CLI_MESHES),
                                0)),
                      ("warm", (n_cells, 0, n_cells))):
        t0 = time.perf_counter()
        text = cli(*sweep, "--out", str(out / f"sweep_{run}"))
        timed[run] = time.perf_counter() - t0
        got = _sweep_counts(text)
        log(f"[cli] {run} sweep: {got[0]} cells, {got[1]} captured, "
            f"{got[2]} cache hits in {timed[run]:.2f} s")
        if run == "cold":
            log(text)
        if got != want:
            fail(f"{run} sweep (cells, captured, hits) {got} != {want}")
    with open(out / "sweep_cold" / "sweep.csv") as f:
        header = f.readline().strip()
        f.seek(0)
        rows = list(csv.DictReader(f))
    if header != SUMMARY_HEADER:
        fail(f"sweep.csv header {header!r} != the reference's")
    calls: dict = {}
    for r in rows:
        if r["algorithm"] == "ring":
            calls.setdefault((r["config"], r["mesh"]), {})[
                r["primitive"]] = int(r["calls"])
    log(f"[cli] cold sweep calls by cell (ring) {calls}")

    mon = out / "monitor"
    text = cli("monitor", "serve", "--formats", "json,csv,html,perfetto",
               "--out", str(mon), *dev, *cache)
    files = sorted(p.name for p in mon.iterdir())
    log(f"[cli] monitor serve wrote {files}")
    if files != ["serve.csv", "serve.html", "serve.json",
                 "serve.trace.json"]:
        fail(f"monitor serve wrote {files}")
    page = (mon / "serve.html").read_text()
    for phase in ("prefill", "decode"):
        n = page.count(f"<h3>phase {phase}: all primitives</h3>")
        if n != 1:
            fail(f"serve.html has {n} heatmap panels of phase {phase}")
    (back,) = export.load_json_reports(str(mon / "serve.json"))
    (entry,) = [export.load_json_reports(e["path"])[0]
                for e in ReportCache(str(out / "cache")).entries()
                if e.get("meta", {}).get("config") == "serve"
                and e["meta"].get("mesh") == "4x2"
                and e["meta"].get("algorithm") == "ring"]
    for phase in back.phase_names():
        if back.view(phase=phase).summary != entry.view(phase=phase).summary \
                or not (back.view(phase=phase).matrix
                        == entry.view(phase=phase).matrix).all():
            fail(f"serve.json's {phase} view differs from the cache entry's")
    log(f"[cli] serve.json reloaded: phases {back.phase_names()}, views "
        "equal to the cache entry's")

    for alg, want in (("ring", 1), ("hierarchical", 0)):
        cli("lint", "paper", "--mesh", "2x2x2", "--algorithms", alg,
            "--fail-on", "error", *dev, *cache, expect=want)
    # the hot expert's all-to-alls: one skewed-a2a warning each on 4x2
    # (data 4: skew 2.4); ``--fail-on warn`` exits 1 on them
    doc = json.loads(cli("lint", "moe-skew", "--mesh", "4x2", "--json",
                         "--fail-on", "warn", *dev, *cache, expect=1))
    rules = [f["rule_id"] for f in doc["findings"]]
    log(f"[cli] lint moe-skew on 4x2: findings {rules}")
    if rules != ["skewed-a2a", "skewed-a2a"]:
        fail(f"lint moe-skew found {rules}, expected two skewed-a2a")

    saved = ROOT / "build" / "chip_smoke_paper_paper_report.json"
    doc = json.loads(cli("compare", str(traces["paper"]), str(saved),
                         "--json"))
    stats = doc["stats"]
    log(f"[cli] compare of the MLP step's live trace against its capture: "
        f"{stats}")
    if stats["unmatched_measured"] or not stats["count"]:
        fail(f"compare left {stats['unmatched_measured']} measured ops "
             f"unmatched ({stats['count']} matched)")

    scale_dir = out / "scale"
    t0 = time.perf_counter()
    cli("sweep", "--scale-curve", "--configs", "serve", "--scale-points",
        CLI_SCALE_POINTS, "--out", str(scale_dir), *dev, *cache)
    timed["scale"] = time.perf_counter() - t0
    scale_csv = (scale_dir / "scale_curve.csv").read_text().splitlines()
    log("\n".join(scale_csv))
    if scale_csv[0] != SCALE_HEADER:
        fail(f"scale_curve.csv header {scale_csv[0]!r} != the reference's")
    if "<svg" not in (scale_dir / "scale_curve.html").read_text():
        fail("scale_curve.html holds no curve")

    for arch in ARCHS:
        row = to_row(roofline_of(captures[arch], mesh_name="4x2"))
        log(f"[roofline] {arch} 4x2 capture (per device, V5E constants): "
            f"{row}")
        if not row["flops/dev"] > 0:
            fail(f"{arch}: the capture counted no FLOPs")
    live, fake = prefill["live"], prefill["fake"]
    bound_ms = max(live["flops"] / BF16_FLOPS,
                   live["bytes accessed"] / HBM_BYTES_PER_S) * 1e3
    log(f"[roofline] qwen3_8b prefill on the card: {live['flops'] / 1e12:.4f} "
        f"TFLOP, {live['bytes accessed'] / 1e9:.4f} GB counted live "
        f"(FakeTensorMode: {fake['flops'] / 1e12:.4f} TFLOP, "
        f"{fake['bytes accessed'] / 1e9:.4f} GB); H100 bound "
        f"{bound_ms:.3f} ms (989 TFLOP/s bf16, 3.35 TB/s) against the "
        f"measured busy {prefill['busy_ms']:.3f} ms")
    if live != fake:
        fail(f"prefill counted live {live} != under FakeTensorMode {fake}")
    if prefill["busy_ms"] is None or bound_ms > prefill["busy_ms"]:
        fail(f"prefill bound {bound_ms} ms exceeds the measured busy time "
             f"{prefill['busy_ms']} ms")
    log(f"[cli] seconds: cold sweep {timed['cold']:.2f}, warm sweep "
        f"{timed['warm']:.2f}, scale curve {timed['scale']:.2f}")
    if calls != CLI_SWEEP_CALLS:
        fail(f"sweep calls by cell {calls} != expected {CLI_SWEEP_CALLS}")


# the run whose counts a kernel's ``launches`` reads: the serve paths, as
# since the port's first slice; the backward kernels, which no serve path
# launches, the lm-train phase
MAIN_PATH = {"rglru_bwd": "lm-train", "flash_attention_bwd": "lm-train"}

# (source, what it replaces): the backward kernels replace no Pallas
# kernel; the reference differentiates its associative scan and its
# chunked attention with XLA
KERNEL_META = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:19"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:35"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:28"),
    "rglru": ("src/repro_torch/kernels/csrc/rglru.cu",
              "src/repro/kernels/rglru/kernel.py:24"),
    "rglru_bwd": ("src/repro_torch/kernels/csrc/rglru.cu",
                  "src/repro/kernels/rglru/ops.py:47"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/ops.py:24"),
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
    by_arch, served = {}, {}
    for arch in SERVE_ARCHS:
        log(f"[serve] {arch}: {torch.cuda.memory_allocated() / 2**30:.2f} "
            "GiB resident before the build")
        by_arch[arch], res = run_serve(arch)
        prof = profile_serve(res)
        served[arch] = dict(prof, **{k: res[k] for k in (
            "prefill_ms", "decode_ms_per_token", "tokens_per_s")},
            max_memory_gib=res["max_memory_bytes"] / 2**30)
        if arch == "qwen3_8b":
            prefill = dict(count_prefill(res), busy_ms=prof["prefill_busy_ms"])
        del res        # free this model before the next one is built
        gc.collect()
        torch.cuda.empty_cache()
    seconds["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    live, traces = run_train()
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = {}
    for arch in LM_ARCHS:
        lm[arch] = run_lm_train(arch)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in LM_ARCHS:
        run_lm_reduced(arch)
    seconds["lm-train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    examples, by_arch["torch_serve_lm"] = run_examples()
    seconds["examples"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reports = {arch: run_monitor(arch) for arch in ARCHS}
    for arch in BACKBONE_ARCHS + SSM_ARCHS + MOE_ARCHS:
        run_monitor(arch)
    for arch in ARCHS:
        run_train_monitor(arch)
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
    t0 = time.perf_counter()
    run_cli(reports, traces, prefill)
    seconds["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = run_dryrun()
    seconds["dryrun"] = time.perf_counter() - t0

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1],
         "main_path": MAIN_PATH.get(name, "serve"),
         "launches": (sum(r["counts"][name] for r in lm.values())
                      if MAIN_PATH.get(name) == "lm-train" else
                      sum(c[name] for c in by_arch.values())),
         "launches_by_arch": {a: c[name] for a, c in by_arch.items()},
         "train_launches_by_arch": {a: r["counts"][name]
                                    for a, r in lm.items()},
         "train_shapes": kernels[name].get("train_shapes", {}),
         **{k: kernels[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
         **{k: kernels[name][k] for k in ("max_rel_err",)
            if k in kernels[name]},
         **({"kv_seq": dict(
             kernels[name]["kv_seq"],
             launches=sum(c["flash_decode_partial"]
                          for c in by_arch.values()),
             launches_by_arch={a: c["flash_decode_partial"]
                               for a, c in by_arch.items()})}
            if "kv_seq" in kernels[name] else {}),
         "grad_max_abs_err": grad_errs[name]}
        for name in KERNEL_META],
        "serve": served,
        "examples": examples,
        "lm_train": {a: {k: r[k] for k in (
            "median_step_ms", "tokens_per_s", "max_memory_gib", "busy_ms",
            "bwd_step_ms", "bwd_ms", "bwd_share", "tflop", "bound_ms")}
            for a, r in lm.items()},
        "dryrun": {k: {"trace_s": round(t, 3), "total_bytes": tot,
                       "alias_bytes": alias,
                       **({"collectives": kinds} if k.endswith(" sp")
                          else {})}
                   for k, (t, tot, alias, kinds) in dry.items()},
        "phase_seconds": {k: round(v, 3) for k, v in seconds.items()}}
    log(json.dumps(line))
    log(gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
