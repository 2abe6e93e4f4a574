"""Serving entry point: batched prefill + decode on one GPU, then the monitored
communication profile of the same serve step on a fake mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \\
        --batch 8 --prompt-len 128 --tokens 32 --report serve_report.json
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma_2b

It builds the architecture (any ``configs.ARCH_IDS`` entry that reads
token ids) at its published width (``--layers`` cuts the depth), with
random weights from seed 0 cast once to bf16, and serves ``--batch``
random prompts through the port's kernels on ``--device`` (default
``cuda``; there is no quiet fallback to the CPU).  The cast takes every
leaf, RecurrentGemma's RG-LRU ``lam``, gate biases and conv bias
included: ``lam`` lies in about
[4.3, 8.9], where the bf16 step is 1/32 to 1/16, so the decays move by a
few percent against fp32 parameters.  Then it captures
prefill and decode as two phases of a ``MonitorSession`` on a fake
``--mesh`` (default 4x2, data x model), prints the per-phase tables and the
decode heatmap, and with ``--report`` saves a schema-v9 report that both
packages load.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import configs, sweep
from repro_torch.core import fake_mesh
from repro_torch.models import build_model
from repro_torch.parallel import Sharder
from repro_torch.serve import generate

WARMUP_TOKENS = 2     # untimed tokens served before the timed run


def resolve_device(device: str) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; no quiet fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port serves on the GPU; pass --device cpu "
            "to run the plain versions on the CPU")
    return dev


def model_config(arch: str, layers: Optional[int] = None,
                 reduced: bool = False):
    cfg = configs.config(arch, reduced=reduced)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def serve(cfg, *, batch: int, prompt_len: int, tokens: int, seed: int = 0,
          device: str = "cuda", dtype: torch.dtype = torch.bfloat16) -> dict:
    """Serve ``batch`` random prompts for ``tokens`` new tokens with random
    weights from ``seed`` (cast to ``dtype`` at load).  Returns the tokens,
    the model and parameters, and the timings: prefill ms, decode ms per
    token (the ``tokens - 1`` decode steps), tokens/s and peak memory.

    The timed run follows an untimed one of :data:`WARMUP_TOKENS` tokens
    over the same prompts, so one-time set-up (library handles, first-call
    dispatch) stays out of the serving times.

    A config that reads embeddings (``input_mode == "embeddings"``:
    Chameleon-34B, MusicGen-medium) is refused: its modality front end is
    a stub, and serving feeds back token ids, as the reference's does."""
    if cfg.input_mode == "embeddings":
        raise ValueError(
            f"{cfg.name} reads embeddings, and its modality front end is a "
            "stub: serving feeds token ids back; drive model.prefill and "
            "model.decode_step with {'embeds': ...} instead")
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, compute_dtype=str(dtype).split(".")[-1])
    model = build_model(cfg)
    params = model.init(seed, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    marks: list[float] = []

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append(time.perf_counter())

    generate(model, params, prompts, Sharder(), steps=WARMUP_TOKENS,
             max_len=prompt_len + tokens)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    clock()
    out = generate(model, params, prompts, Sharder(), steps=tokens,
                   max_len=prompt_len + tokens, clock=clock)
    prefill_s, decode_s = marks[1] - marks[0], marks[2] - marks[1]
    return {
        "model": model, "params": params, "prompts": prompts, "tokens": out,
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_token": decode_s * 1e3 / max(1, tokens - 1),
        "tokens_per_s": batch * tokens / (marks[2] - marks[0]),
        "max_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None),
    }


def monitor(cfg, *, mesh_shape=(4, 2), batch: int, prompt_len: int,
            tokens: int, device: str = "cuda", name: str = ""):
    """Two-phase (prefill, decode) capture of the serve step on a fake
    ``data x model`` mesh under ``FakeTensorMode``, bf16 parameters:
    nothing is allocated.  Returns the session's
    :class:`~repro_torch.core.CommReport`."""
    dev = resolve_device(device)
    names = ("data", "model")[:len(mesh_shape)]
    mesh = fake_mesh(mesh_shape, names, device=dev.type)
    return sweep._monitor_cell(
        lambda m: sweep.serve_cell(m, cfg, batch=batch,
                                   prompt_len=prompt_len,
                                   max_len=prompt_len + tokens,
                                   dtype=torch.bfloat16),
        mesh, name or f"serve[{cfg.name}]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3_8b", choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: published)")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's test-scale config")
    ap.add_argument("--mesh", default="4x2",
                    help="monitored fake mesh, data x model")
    ap.add_argument("--report", default="", help="save the report here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_config(args.arch, args.layers or None, args.reduced)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                tokens=args.tokens, device=args.device)
    print(f"[serve] {cfg.name} {cfg.n_layers}L on {args.device}: "
          f"prefill {res['prefill_ms']:.2f} ms, decode "
          f"{res['decode_ms_per_token']:.2f} ms/token, "
          f"{res['tokens_per_s']:.1f} tok/s")
    print("[serve] sample:", res["tokens"][0, :16].tolist())

    shape = tuple(int(x) for x in args.mesh.split("x"))
    rep = monitor(cfg, mesh_shape=shape, batch=args.batch,
                  prompt_len=args.prompt_len, tokens=args.tokens,
                  device=args.device)
    print(rep.phase_table())
    print(rep.heatmap(phase="decode"))
    if args.report:
        rep.save(args.report)
        print(f"[serve] report saved to {args.report}")
    return res["tokens"]


if __name__ == "__main__":
    main()
