"""Serve traffic: one closed-loop caller sends a batch of prompts to
``repro_torch.serve.generate`` and sends the next when it returns.

The traffic file gives ``batch``, ``prompt_len``, ``new_tokens`` (greedy)
and ``sample_calls``: how many whole calls of the window, drawn from the
seed, the reference follows.  Prompts are token ids drawn uniformly on
the device from the seed, a fresh batch each call; the weights are drawn
on the device from the seed in the configuration's serve dtype.

Times come from ``generate``'s own ``clock`` callback, which this loop
makes end in ``torch.cuda.synchronize``: once after the prefill and the
first token, once after the last token.  The requests of one call share
its times (the port batches synchronously, with no request scheduler).
"""
from __future__ import annotations

import random
import time

import torch

from chipbench import counts, port, weights
from chipbench.reference import model as ref
from chipbench.reference.precision import fp8_matmul


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.b, self.p, self.o = t["batch"], t["prompt_len"], t["new_tokens"]
        self.run = ctx.run
        self.dtype = getattr(torch, ctx.config["serve_dtype"])
        self.calls: list = []
        self.routes = None

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.models import build_model
        from repro_torch.parallel import Sharder

        ctx, dev = self.ctx, self.ctx.device
        cfg = port.model_config(self.run, ctx.log)
        self.model = build_model(cfg)
        ctx.log(f"[setup] model built {ctx.clock():.3f} s")
        self.W = weights.draw(self.run, ctx.seed, dev, self.dtype)
        port.check_tree(self.model, self.W)
        _sync(dev)
        ctx.log(f"[setup] weights drawn {ctx.clock():.3f} s")
        self.params = weights.as_tree(self.W)
        self.shd = Sharder()
        self.gen = torch.Generator(device=dev).manual_seed(
            weights.tensor_seed(ctx.seed, "prompts"))
        warm = torch.Generator(device=dev).manual_seed(
            weights.tensor_seed(ctx.seed, "warm-up"))
        self._generate(self._prompts(warm), steps=2)
        _sync(dev)
        ctx.log(f"[setup] warmed up {ctx.clock():.3f} s")

    def _prompts(self, gen):
        return torch.randint(0, self.run["vocab_size"], (self.b, self.p),
                             generator=gen, device=self.ctx.device)

    def _generate(self, prompts, steps, clock=None):
        from repro_torch.serve import generate
        return generate(self.model, self.params, prompts, self.shd,
                        steps=steps, max_len=self.p + self.o,
                        temperature=0.0, clock=clock)

    # -- the window ----------------------------------------------------------
    def unit(self, trace) -> dict:
        dev = self.ctx.device
        prompts = self._prompts(self.gen)
        marks: list = []

        def clock():
            _sync(dev)
            marks.append(time.perf_counter())
            trace.mark("decode" if len(marks) == 1 else "between calls")

        trace.mark("prefill")
        start = time.perf_counter()
        out = self._generate(prompts, self.o, clock)
        self.calls.append((prompts, out))
        return {"start": start, "first": marks[0], "end": marks[1],
                "requests": self.b, "tokens": self.b * self.o, "failed": 0}

    def audit(self, units) -> None:
        """Requests whose tokens are out of the vocabulary or missing
        count as failed."""
        for rec, (_, out) in zip(units, self.calls):
            good = (out.shape == (self.b, self.o)) and bool(
                ((out >= 0) & (out < self.run["vocab_size"])).all())
            rec["failed"] = 0 if good else self.b

    def kernel_calls(self, units) -> list:
        """The port's kernel calls the window's calls make, from the
        shapes: per prefill two RMSNorms a layer over every prompt row
        and the final one over the last position, one flash attention a
        layer; per decode step ``2L + 1`` RMSNorms and one flash decode a
        layer over the live cache."""
        r, n = self.run, len(units)
        L, b, p, o = r["n_layers"], self.b, self.p, self.o
        heads = dict(h=r["n_heads"], kvh=r["n_kv_heads"], dh=r["head_dim"])
        calls = [("rmsnorm", dict(rows=b * p, d=r["d_model"]), n * 2 * L),
                 ("rmsnorm", dict(rows=b, d=r["d_model"]),
                  n * (1 + (o - 1) * (2 * L + 1))),
                 ("flash_attention", dict(b=b, sq=p, skv=p, **heads), n * L)]
        calls += [("flash_decode", dict(b=b, live=p + t + 1, **heads), n * L)
                  for t in range(o - 1)]
        return calls

    def step_least(self, units) -> list:
        """Least seconds of each call: its prefill and decode steps, each
        the larger of its model FLOPs at peak and its least bytes at the
        HBM rate, counting the experts routed as the reference routed the
        followed calls (see :meth:`routed`)."""
        dt = self.ctx.config["serve_dtype"]
        out = []
        for i in range(len(units)):
            routed = self.routed(i)
            t = counts.prefill_least(self.run, dt, self.b, self.p, routed[0])
            for s in range(1, self.o):
                t += counts.decode_least(self.run, dt, self.b, self.p + s,
                                         routed[s])
            out.append(t)
        return out

    def routed(self, i: int) -> list:
        """Experts routed a layer, for each step of call ``i``: counted
        from the reference's routing of that call where it followed it,
        else the least over the followed calls at the same step (None for
        a dense model: every weight)."""
        if not self.run["n_experts"] or not self.routes:
            return [None] * self.o
        if i in self.routes:
            return self.routes[i]
        return [[min(c[s][l] for c in self.routes.values())
                 for l in range(self.run["n_layers"])]
                for s in range(self.o)]

    def finish(self) -> None:
        del self.params, self.model
        self.calls = [(p.cpu(), o.cpu()) for p, o in self.calls]

    # -- correctness ---------------------------------------------------------
    def followed(self) -> list:
        rng = random.Random(weights.tensor_seed(self.ctx.seed, "sample"))
        n = min(self.ctx.traffic["sample_calls"], len(self.calls))
        return sorted(rng.sample(range(len(self.calls)), n))

    def reference_logits(self, idx, mm=ref.plain_mm, routes=None):
        dev = self.ctx.device
        prompts = torch.cat([self.calls[i][0] for i in idx]).to(dev)
        served = torch.cat([self.calls[i][1] for i in idx]).to(dev)
        rows = max(1, self.ctx.traffic["reference_tokens"]
                   // (self.p + self.o))
        return served, ref.served_logits(self.W, self.run, prompts, served,
                                         mm, routes, rows)

    def check(self) -> dict:
        """Follow the sampled calls with the reference and read, for each
        served token, how far its reference logit lies below the
        reference's best at its position (:func:`gap_numbers`; the cell's
        limits file says which of them are compared)."""
        idx = self.followed()
        blocks: list = []
        served, lg = self.reference_logits(idx, routes=blocks)
        self._count_routes(idx, blocks)
        return gap_numbers(lg, served)

    def control(self) -> dict:
        """The same followed calls, the reference's linear layers in FP8:
        at each position the token FP8 puts first, read in the float32
        reference's logits."""
        idx = self.followed()
        served, lg = self.reference_logits(idx)
        _, lo = self.reference_logits(idx, mm=fp8_matmul)
        return gap_numbers(lg, lo.argmax(-1))

    def _count_routes(self, idx, blocks) -> None:
        """Distinct experts a layer in each step of each followed call."""
        if not self.run["n_experts"]:
            return
        kept = [torch.cat([blk[l] for blk in blocks])
                for l in range(self.run["n_layers"])]      # (N, S, k)
        self.routes = {}
        for j, i in enumerate(idx):
            rows = slice(j * self.b, (j + 1) * self.b)
            steps = []
            for s in range(self.o):
                pos = slice(0, self.p) if s == 0 else slice(
                    self.p + s - 1, self.p + s)
                steps.append([int(torch.unique(
                    kept[l][rows, pos][kept[l][rows, pos] >= 0]).numel())
                    for l in range(self.run["n_layers"])])
            self.routes[i] = steps


def gap_numbers(logits, tokens) -> dict:
    """How far below the reference's best the chosen tokens' reference
    logits lie.  Compared (``chipbench/limits``): the mean gap with the
    widest 1% left out (a few tokens whose experts changed under bf16
    rounding set the widest gaps of a sound run), and the share of tokens
    more than 0.05 below the best (about one and a half bf16 steps at the
    logits' scale, where ties are rounding).  Reported beside them: the
    widest gap, the mean, and the share not the best."""
    lg = logits.float()
    gap = (lg.max(-1).values - lg.gather(-1, tokens[..., None].to(
        lg.device).long())[..., 0]).flatten()
    kept = gap.sort().values[:max(1, int(0.99 * gap.numel()))]
    return {"gap_mean_trim1": float(kept.mean()),
            "share_over_0.05": float((gap > 0.05).float().mean()),
            "gap_max": float(gap.max()), "gap_mean": float(gap.mean()),
            "mismatch_share": float((gap > 0).float().mean()),
            "tokens_compared": int(gap.numel())}
