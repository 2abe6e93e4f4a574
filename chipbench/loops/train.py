"""Train traffic: the step ``repro_torch.train.make_train_step`` returns,
driven in a closed loop over state the benchmark built.

The traffic file gives ``global_batch`` sequences of ``seq_len`` tokens a
step in ``microbatches``, and ``reference_steps``: the first steps, run
in set-up through the window's own call and feed (they also warm up every
shape), which the reference follows.  Token
ids are drawn uniformly on the device from the seed, fresh rows every
step; the labels are the ids shifted by one.

The state is ``{"params", "opt", "step"}`` as the port's
``init_train_state`` builds it, but with the benchmark's own weights
(drawn on the device from the seed, so that the reference can draw them
again) and the port's ``init_opt_state``.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from chipbench import counts, port, weights
from chipbench.reference import adamw
from chipbench.reference import model as ref
from chipbench.reference.precision import fp8_matmul


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.b, self.s = t["global_batch"], t["seq_len"]
        self.run = ctx.run
        self.hyper = ctx.config["train"]
        self.readings: dict = {}

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.models import build_model
        from repro_torch.optim import OptConfig, init_opt_state
        from repro_torch.parallel import Sharder
        from repro_torch.train import TrainConfig, make_train_step

        ctx, dev, h = self.ctx, self.ctx.device, self.hyper
        cfg = port.model_config(self.run, ctx.log)
        self.model = build_model(cfg)
        ocfg = OptConfig(
            name="adamw", peak_lr=h["peak_lr"],
            warmup_steps=h["warmup_steps"], decay_steps=h["decay_steps"],
            min_lr_ratio=h["min_lr_ratio"], b1=h["b1"], b2=h["b2"],
            eps=h["eps"], weight_decay=h["weight_decay"],
            grad_clip=h["grad_clip"], state_dtype=h["state_dtype"])
        tcfg = TrainConfig(microbatches=ctx.traffic["microbatches"],
                           remat=h["remat"], accum_dtype=h["accum_dtype"])
        flat = weights.draw(self.run, ctx.seed, dev,
                            getattr(torch, self.run["param_dtype"]))
        port.check_tree(self.model, flat)
        _sync(dev)
        ctx.log(f"[setup] weights drawn {ctx.clock():.3f} s")
        params = weights.as_tree(flat)
        self.state = {"params": params, "opt": init_opt_state(params, ocfg),
                      "step": torch.zeros((), dtype=torch.int32, device=dev)}
        self.step_fn = make_train_step(self.model, ocfg, tcfg, Sharder())
        self.data = self._data()
        self.names = list(flat)
        del flat
        losses = []
        for i in range(ctx.traffic["reference_steps"]):
            self.state, m = self.step_fn(self.state, self._batch(self.data))
            losses.append(float(m["loss"]))
            ctx.log(f"[setup] step {i + 1} {ctx.clock():.3f} s")
            if i == 0:
                self.readings["grad"] = self._first_grad_norms()
        self.readings["change"] = self._change_norms()
        self.readings["loss"] = losses
        _sync(dev)

    def _data(self):
        return torch.Generator(device=self.ctx.device).manual_seed(
            weights.tensor_seed(self.ctx.seed, "tokens"))

    def _batch(self, gen) -> dict:
        t = torch.randint(0, self.run["vocab_size"], (self.b, self.s + 1),
                          generator=gen, device=self.ctx.device)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def _leaf(self, tree, name):
        for p in name.split("."):
            tree = tree[p]
        return tree

    def _first_grad_norms(self) -> dict:
        """Each leaf's clipped first gradient as AdamW got it, from its
        first moment after one step: ``|m| / (1 - b1)``."""
        return {n: float(self._leaf(self.state["opt"], n)["m"].norm())
                / (1 - self.hyper["b1"]) for n in self.names}

    def _change_norms(self) -> dict:
        """Each leaf's distance from its drawn start."""
        out = {}
        for n in self.names:
            p = self._leaf(self.state["params"], n)
            p0 = weights.draw_leaf(self.run, self.ctx.seed, n, p.device,
                                   p.dtype)
            out[n] = float(p0.sub_(p).norm())
            del p0
        return out

    # -- the window ----------------------------------------------------------
    def unit(self, trace) -> dict:
        dev = self.ctx.device
        batch = self._batch(self.data)
        trace.mark("train_step")
        start = time.perf_counter()
        self.state, m = self.step_fn(self.state, batch)
        _sync(dev)
        end = time.perf_counter()
        trace.mark("between steps")
        return {"start": start, "end": end, "tokens": self.b * self.s,
                "requests": 1, "loss": m["loss"], "failed": 0}

    def audit(self, units) -> None:
        """A step whose loss is not finite counts as failed."""
        for rec in units:
            rec["failed"] = 0 if math.isfinite(float(rec.pop("loss"))) else 1

    def kernel_calls(self, units) -> list:
        """Per microbatch and layer, under ``remat: full``, two RMSNorms
        and one flash attention in the forward and the same again in the
        recompute; the final RMSNorm once a microbatch (the backwards are
        plain PyTorch)."""
        r, n = self.run, len(units)
        a = self.ctx.traffic["microbatches"]
        rows, L = self.b // a * self.s, r["n_layers"]
        remat = 2 if self.hyper["remat"] == "full" else 1
        heads = dict(h=r["n_heads"], kvh=r["n_kv_heads"], dh=r["head_dim"])
        return [("rmsnorm", dict(rows=rows, d=r["d_model"]),
                 n * a * (2 * L * remat + 1)),
                ("flash_attention", dict(b=self.b // a, sq=self.s,
                                         skv=self.s, **heads),
                 n * a * L * remat)]

    def step_flops(self) -> float:
        return counts.train_step_flops(self.run, self.b, self.s)

    def finish(self) -> None:
        del self.state, self.step_fn, self.model

    # -- correctness ---------------------------------------------------------
    def follow(self, mm=ref.plain_mm) -> dict:
        """The reference over the same start and batches: each step's
        loss, each leaf's clipped first gradient, and each leaf's change
        after ``reference_steps``, with each leaf's raw first gradient
        (``ref_grad``) for the rule on near-zero leaves.  A stacked leaf
        is held as one autograd leaf a layer (views of it), so that no
        layer's gradient is a whole stacked tensor."""
        dev, h = self.ctx.device, self.hyper
        rows = self.ctx.traffic["reference_rows"]
        W, parts = {}, {}
        for n in self.names:
            t = weights.draw_leaf(self.run, self.ctx.seed, n, dev,
                                  torch.float32)
            if n.startswith("layers."):
                W[n] = [v.detach().requires_grad_() for v in t.unbind(0)]
            else:
                W[n] = t.requires_grad_()
            parts[n] = W[n] if isinstance(W[n], list) else [W[n]]
        flat = {f"{n}#{i}": v for n, ps in parts.items()
                for i, v in enumerate(ps)}
        gen = self._data()
        state: dict = {}
        out: dict = {"loss": []}
        for t in range(self.ctx.traffic["reference_steps"]):
            batch = self._batch(gen)
            total = 0.0
            for a in range(0, self.b, rows):
                loss = ref.loss(W, self.run, batch["tokens"][a:a + rows],
                                batch["labels"][a:a + rows], mm) \
                    * (min(rows, self.b - a) / self.b)
                loss.backward()
                total += float(loss.detach())
            out["loss"].append(total)
            grads = {k: v.grad for k, v in flat.items()}
            clip = adamw.clip_factor(h, grads)
            if t == 0:
                raw = {n: _norm([p.grad for p in ps])
                       for n, ps in parts.items()}
                out["ref_grad"] = raw
                out["grad"] = {n: clip * g for n, g in raw.items()}
            adamw.step({k: v.data for k, v in flat.items()}, grads, state,
                       h, t, clip)
            for v in flat.values():
                v.grad = None
        del state, grads
        out["change"] = {}
        for n, ps in parts.items():
            p0 = weights.draw_leaf(self.run, self.ctx.seed, n, dev,
                                   torch.float32)
            out["change"][n] = _norm([p0[i].sub_(p.data) if len(ps) > 1
                                      else p0.sub_(p.data)
                                      for i, p in enumerate(ps)])
            del p0
        return out

    def check(self) -> dict:
        self.reference = self.follow()
        return train_numbers(self.readings, self.reference)

    def control(self) -> dict:
        """The reference with FP8 linear layers, read as the program is."""
        ctrl = self.follow(fp8_matmul)
        return train_numbers(ctrl, self.reference)


def _norm(tensors) -> float:
    """The norm of tensors taken together."""
    return math.sqrt(sum(float(t.norm()) ** 2 for t in tensors))


def leaf_gaps(got: dict, want: dict, leaves) -> dict:
    """Each leaf's ``|got| - |want|`` gap over the larger of its own
    reference norm and the median leaf's."""
    med = statistics.median([want[n] for n in leaves])
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in leaves}


def train_numbers(got: dict, ref_: dict) -> dict:
    """The numbers compared: the largest relative loss gap over the steps
    followed, and the worst leaf's gap of the first gradient's norm and of
    the change's norm.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam and
    are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                    ref_["loss"]))
    names = list(ref_["grad"])
    med = statistics.median([ref_["ref_grad"][n] for n in names])
    moved = [n for n in names if ref_["ref_grad"][n] >= 1e-3 * med]
    grad = leaf_gaps(got["grad"], ref_["grad"], names)
    change = leaf_gaps(got["change"], ref_["change"], moved)
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "worst_grad_leaf": max(grad, key=grad.get),
            "worst_change_leaf": max(change, key=change.get),
            "leaves_left_out": sorted(set(names) - set(moved))}
