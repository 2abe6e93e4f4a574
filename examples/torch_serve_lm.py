"""Serve a small LM with batched requests and a monitored serve session, on
the PyTorch port.

Uses the qwen3-family reduced config: serve the prompt batch live on one
device through the port's kernels (flash attention in the prefill, flash
decode in every decode step, RMSNorm in every block; their plain versions
on the CPU), then monitor prefill AND decode as the two named phases of one
:class:`~repro_torch.core.session.MonitorSession` on a fake (data=4,
model=2) mesh -- the per-phase tables show the prefill all-gather-heavy
profile next to the decode profile (the same cells ``python -m repro_torch
sweep --configs serve --by-phase`` sweeps).

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--tokens 24] \\
          [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import serve as launch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    launch.resolve_device(args.device)

    cfg = launch.model_config(args.arch, reduced=True)
    # random bf16 weights from seed 0, random prompts; one untimed warm-up
    # generate, then the timed one
    res = launch.serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                       tokens=args.tokens, device=args.device)
    out = res["tokens"]
    print(f"served {args.batch} requests x {args.tokens} tokens: prefill "
          f"{res['prefill_ms']:.2f} ms, decode "
          f"{res['decode_ms_per_token']:.2f} ms/token "
          f"({res['tokens_per_s']:.1f} tok/s)")
    print("sample completion ids:", out[0, :12].tolist())

    # prefill/decode communication profile: one two-phase session over
    # fake-tensor stand-ins (no allocation, nothing executes)
    rep = launch.monitor(cfg, mesh_shape=(4, 2), batch=args.batch,
                         prompt_len=args.prompt_len, tokens=args.tokens,
                         device=args.device)
    print()
    print(rep.phase_table())
    print(rep.phase_diff("prefill", "decode"))
    print(rep.heatmap(phase="decode"))
    print("serving example OK")
    return {"tokens": out, "report": rep,
            **{k: res[k] for k in ("prefill_ms", "decode_ms_per_token",
                                   "tokens_per_s")}}


if __name__ == "__main__":
    main()
