"""xLSTM (port of ``repro.models.xlstm``): alternating mLSTM (matrix
memory) and sLSTM (scalar memory) blocks, arXiv 2405.04517.

* **mLSTM** -- training and prefill use the parallel form: the
  exponential-gated matrix-memory recurrence
  ``C_t = f_t C_{t-1} + i_t v_t k_t^T``, ``h_t = C_t q_t / max(|n_t q_t|,
  e^-m)`` is a decay-masked linear attention, the custom op
  ``repro_torch::mlstm_parallel`` (:mod:`.mlstm_parallel`), its backward
  ``repro_torch::mlstm_parallel_bwd``.  Decode uses the exact O(1)
  stabilised recurrence on ``(C, n, m)``.
* **sLSTM** -- sequential, with recurrent weights: the time loop is the
  custom op ``repro_torch::slstm_scan`` (:mod:`.slstm_scan`), its
  backward ``repro_torch::slstm_scan_bwd``.

xLSTM-1.3B: 48 layers = 24 (mLSTM, sLSTM) superblocks, d_model 2048,
4 heads; the reference's layout gives 2,623,686,848 parameters.

Where the port differs from the reference:

* The chunked parallel form is one loop over query chunks, each against
  its whole key prefix in one batched product; the reference scans
  (query chunk, key chunk) pairs with an online max.  The two agree to
  fp32 rounding, not bit for bit.  It runs inside one op, its backward
  the form's analytic gradient.
* The sLSTM loop runs inside one op (the reference traces a two-level
  ``lax.scan`` once), so a capture records it once; its backward is the
  loop's analytic gradient, recomputed a 256-step chunk at a time as the
  reference's ``jax.checkpoint(outer)`` recomputes its chunks.  (Ops,
  because a capture would otherwise record every step and every query
  chunk: thousands of ops a layer at a production sequence.)
* The superblocks are a Python loop over the stacked leaves (the
  reference scans), each superblock of ``loss_fn`` under the ``dots``
  remat policy whatever ``remat`` says, as the reference checkpoints it.
* ``decode_step`` writes the new states into the caller's cache tensors in
  place and advances ``len`` in place (the reference returns a new cache).
* On a mesh the mLSTM cell and the sLSTM loop run on local shards
  (``Sharder.local``): the parallel form on whole heads (over ``model``
  where it divides the heads, else replicated); the decode step and the
  prefill's final state in the cache's layout (``C`` split along its v
  rows over ``inner``, with ``q``, ``k`` and ``n`` whole); the sLSTM loop
  on whole heads, its ``r_g`` gathered to them, or replicated over
  ``model`` where ``model`` does not divide the heads (16 on the
  production mesh), as the MoE block's TP-experts fallback.
* Under the ``seq -> model`` rule (sequence parallelism) both
  recurrences, and the mLSTM conv, run on the whole sequence in the
  layouts above; the norms and the products around them run on the
  sequence shards.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import layers
from .common import (ModelConfig, Spec, init_params, layer_of, param_axes,
                     param_shapes, rms_norm)
from .mlstm_parallel import mlstm_parallel
from .rglru import _stack, _store, temporal_conv
from .slstm_scan import slstm_scan
from .transformer import with_remat

NEG_INF = -1e30
STATE_DTYPE = torch.float32      # every recurrent state, as the reference
ACT = ("batch", "seq", None)
# the recurrences' layouts keep the sequence whole (both are recurrences
# over all of it): under the ``seq -> model`` rule a sequence split enters
# them by an all-to-all and leaves them by another
INNER = ("batch", None, "inner")
GATES = ("z", "i", "f", "o")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def mlstm_spec(cfg: ModelConfig, stacked: int = 0) -> dict:
    d = cfg.d_model
    di = 2 * d
    nh = cfg.n_heads
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    return {
        "norm": layers.norm_spec(cfg, stacked=stacked),
        "w_up": Spec(lead + (d, 2 * di), lx + ("embed", "inner")),
        "conv_w": Spec(lead + (cfg.conv_width, di), lx + ("conv", "inner"),
                       scale=0.5),
        "conv_b": Spec(lead + (di,), lx + ("inner",), init="zeros"),
        "wq": Spec(lead + (di, di), lx + ("inner", None)),
        "wk": Spec(lead + (di, di), lx + ("inner", None)),
        "wv": Spec(lead + (di, di), lx + ("inner", None)),
        "w_i": Spec(lead + (di, nh), lx + ("inner", None), scale=0.1),
        "b_i": Spec(lead + (nh,), lx + (None,), init="zeros"),
        "w_f": Spec(lead + (di, nh), lx + ("inner", None), scale=0.1),
        "b_f": Spec(lead + (nh,), lx + (None,), init="ones"),
        "head_norm": Spec(lead + (di,), lx + ("inner",), init="ones"),
        "w_down": Spec(lead + (di, d), lx + ("inner", "embed")),
    }


def slstm_spec(cfg: ModelConfig, stacked: int = 0) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    gates = {}
    for g in GATES:
        gates[f"w_{g}"] = Spec(lead + (d, d), lx + ("embed", "inner"))
        gates[f"r_{g}"] = Spec(lead + (nh, dh, dh), lx + (None, "inner", None),
                               scale=0.5)
        gates[f"b_{g}"] = Spec(lead + (d,), lx + ("inner",),
                               init="ones" if g == "f" else "zeros")
    return {
        "norm": layers.norm_spec(cfg, stacked=stacked),
        **gates,
        "head_norm": Spec(lead + (d,), lx + ("inner",), init="ones"),
        "w_out": Spec(lead + (d, d), lx + ("inner", "embed")),
    }


# ---------------------------------------------------------------------------
# mLSTM: parallel (quadratic) form, decode step, final state
# ---------------------------------------------------------------------------
def _mlstm_gates(p, xc, shd=None):
    """xc: (B,S,di) conv branch -> (log_f, itilde): (B,S,nh) fp32.  On a
    mesh each product is laid out by heads before its bias, and the
    log-sigmoid runs on local shards (DTensor has no rule for its
    backward)."""
    xf = xc.float()
    ax = ("batch", None, "heads")
    mesh = shd is not None and shd.mesh is not None

    def gate(w, b):
        out = xf @ w.float()
        if mesh:
            out = shd.constraint(out, ax)
        return out + b.float()

    itilde = gate(p["w_i"], p["b_i"])
    ftilde = gate(p["w_f"], p["b_f"])
    if not mesh:
        return F.logsigmoid(ftilde), itilde
    return shd.local(F.logsigmoid, (ftilde,), (ax,)), itilde


def mlstm_decode_step(q, k, v, log_f, itilde, state):
    """Exact O(1) stabilized recurrence.  q,k,v: (B,nh,dh); gates: (B,nh).

    state: {"C": (B,nh,dh,dh), "n": (B,nh,dh), "m": (B,nh)}.  ``C`` and
    ``v`` may hold a slice of the v rows (a mesh shard): the update and
    the output are row by row; ``q``, ``k`` and ``n`` are whole."""
    scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    kf = k.float()
    m_new = torch.maximum(log_f + state["m"], itilde)
    fprime = torch.exp(log_f + state["m"] - m_new)
    iprime = torch.exp(itilde - m_new)
    C = state["C"] * fprime[..., None, None] + iprime[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v.float(), kf)
    n = state["n"] * fprime[..., None] + iprime[..., None] * kf
    num = torch.einsum("bhde,bhe->bhd", C, qf)
    den = torch.einsum("bhd,bhd->bh", n, qf).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return h, {"C": C, "n": n, "m": m_new}


def mlstm_final_state(k, v, log_f, itilde):
    """State after consuming a sequence (prefill).  k,v: (B,S,nh,dh)."""
    bcum = torch.cumsum(log_f, dim=1)
    btot = bcum[:, -1]                                      # (B,nh)
    d_ = btot[:, None] - bcum + itilde                      # (B,S,nh)
    m = d_.amax(dim=1)                                      # (B,nh)
    w = torch.exp(d_ - m[:, None])                          # (B,S,nh)
    kf, vf = k.float(), v.float()
    C = torch.einsum("bshd,bshe->bhde", w[..., None] * vf, kf)
    n = torch.einsum("bsh,bshd->bhd", w, kf)
    return {"C": C, "n": n, "m": m}


def _final_state_tuple(k, v, log_f, itilde):
    st = mlstm_final_state(k, v, log_f, itilde)
    return st["C"], st["n"], st["m"]


def _decode_tuple(q, k, v, log_f, itilde, C, n, m):
    h, st = mlstm_decode_step(q, k, v, log_f, itilde,
                              {"C": C, "n": n, "m": m})
    return h, st["C"], st["n"], st["m"]


def mlstm_block_apply(p, x, cfg: ModelConfig, shd,
                      state: Optional[dict] = None):
    """Full mLSTM residual block.  x: (B,S,D) -> ``(out, new_state)``.

    ``state`` None: no state (training).  With S == 1 a decode step over
    ``{"C", "n", "m", "conv"}``.  Otherwise a prefill from the zero state
    (only ``state.get("conv")`` is read, as the reference's prefill
    branch): the parallel outputs plus the final recurrent state."""
    d = cfg.d_model
    di = 2 * d
    nh = cfg.n_heads
    dh = di // nh
    dt = x.dtype
    b, s, _ = x.shape
    mesh = shd.mesh is not None

    h = rms_norm(x, p["norm"], cfg.norm_eps, shd, ACT)
    up = shd.constraint(shd.matmul(h, p["w_up"].to(dt)), INNER)
    xm, z = torch.chunk(up, 2, dim=-1)
    conv_buf = None if state is None else state.get("conv")
    xc, new_conv = temporal_conv(p, xm, cfg, shd, conv_buf, channel="inner")
    xc = F.silu(xc)

    q = (xc @ p["wq"].to(dt)).reshape(b, s, nh, dh)
    k = (xc @ p["wk"].to(dt)).reshape(b, s, nh, dh)
    v = (xm @ p["wv"].to(dt)).reshape(b, s, nh, dh)
    log_f, itilde = _mlstm_gates(p, xc, shd)

    heads4, heads3 = ("batch", None, "heads", None), ("batch", None,
                                                     "heads")
    ax = mlstm_state_axes()
    new_state = None
    if state is None or s > 1:
        ht = shd.local(functools.partial(mlstm_parallel,
                                         chunk=cfg.mlstm_chunk),
                       (q, k, v, log_f, itilde),
                       (heads4, heads4, heads4, heads3, heads3))
    if state is not None and s == 1:
        hd, C, n, m = shd.local(
            _decode_tuple,
            (q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], itilde[:, 0],
             state["C"], state["n"], state["m"]),
            (("batch", None, None), ("batch", None, None),
             ("batch", None, "inner"), ("batch", None), ("batch", None),
             ax["C"], ("batch", None, None), ax["m"]), out=(2, 5, 6, 7))
        # h leaves split along dh: gathered before the heads are merged
        ht = shd.constraint(hd, ("batch", None, None))[:, None]
        new_state = {"C": C, "n": n, "m": m,
                     "conv": new_conv.to(STATE_DTYPE)}
    elif state is not None:
        whole = ("batch", None, None, None)
        out_pl = None
        if mesh:
            out_pl = (list(shd.placements((b, nh, dh, dh), ax["C"])),
                      list(shd.placements((b, nh, dh), ("batch", None,
                                                        None))),
                      list(shd.placements((b, nh), ax["m"])))
        C, n, m = shd.local(
            _final_state_tuple, (k, v, log_f, itilde),
            (whole, ("batch", None, None, "inner"), ("batch", None, None),
             ("batch", None, None)), out_placements=out_pl)
        new_state = {"C": C, "n": shd.constraint(n, ax["n"]), "m": m,
                     "conv": new_conv.to(STATE_DTYPE)}

    ht = ht.reshape(b, s, di)
    ht = rms_norm(ht.to(dt), p["head_norm"], cfg.norm_eps, shd, ACT)
    if shd.seq_sharded(ht):
        z = shd.constraint(z, ACT)
    out = ht * F.silu(z)
    out = shd.matmul(out, p["w_down"].to(dt))
    return x + shd.constraint(out, ACT), new_state


def mlstm_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    di = 2 * cfg.d_model
    nh = cfg.n_heads
    dh = di // nh
    return {"C": (batch, nh, dh, dh), "n": (batch, nh, dh), "m": (batch, nh),
            "conv": (batch, cfg.conv_width - 1, di)}


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cuda"):
    """The zero state, ``m`` at -1e30 (the reference's)."""
    st = {k: torch.zeros(shape, dtype=STATE_DTYPE, device=device)
          for k, shape in mlstm_state_shapes(cfg, batch).items()}
    st["m"].fill_(NEG_INF)
    return st


def mlstm_state_axes():
    return {"C": ("batch", None, "inner", None),
            "n": ("batch", None, "inner"),
            "m": ("batch", None),
            "conv": ("batch", None, "inner")}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def _head_axis(cfg: ModelConfig, shd) -> Optional[str]:
    """``inner`` where the mesh's ``inner`` split keeps whole heads (the
    sLSTM runs a rank's own heads), else None (replicated over it)."""
    return "inner" if cfg.n_heads % shd.logical_size("inner") == 0 else None


def slstm_apply(p, x, cfg: ModelConfig, shd, state: Optional[dict] = None,
                chunk: int = 256):
    """x: (B,S,D) -> ``(out, new_state)``; ``new_state`` is the final
    carry ``{"c", "n", "m", "h"}`` (B,d) fp32, from ``state`` or, None,
    from the zero carry.  ``chunk`` is the reference's own default (the
    backward's recompute length), not ``cfg.mlstm_chunk``."""
    d = cfg.d_model
    b, s, _ = x.shape
    h_in = rms_norm(x, p["norm"], cfg.norm_eps, shd, ACT)
    xf = h_in.float()
    hax = _head_axis(cfg, shd)
    gax = ("batch", None, hax)

    def gate(g):
        return shd.constraint(shd.matmul(xf, p[f"w_{g}"].float()), gax) \
            + p[f"b_{g}"].float()

    xg = torch.stack([gate(g) for g in GATES], dim=2)      # (B,S,4,d)
    r = torch.stack([p[f"r_{g}"].float() for g in GATES])  # (4,nh,dh,dh)
    st = None if state is None else torch.stack(
        [state[k] for k in ("c", "n", "m", "h")])
    out_pl = None
    if shd.mesh is not None:
        out_pl = (list(shd.placements((b, s, d), gax)),
                  list(shd.placements((4, b, d), (None, "batch", hax))))
    hs, carry = shd.local(
        functools.partial(slstm_scan, chunk=chunk), (xg, r, st),
        (("batch", None, None, hax),
         (None, "heads" if hax else None, None, None),
         (None, "batch", hax)), out_placements=out_pl)
    new_state = dict(zip(("c", "n", "m", "h"), carry.unbind(0)))
    dt = x.dtype
    hs = rms_norm(hs.to(dt), p["head_norm"], cfg.norm_eps, shd, ACT)
    out = shd.matmul(hs, p["w_out"].to(dt))
    return x + shd.constraint(out, ACT), new_state


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda"):
    """The zero carry, ``m`` at -1e30 (the reference's)."""
    d = cfg.d_model
    st = {k: torch.zeros((batch, d), dtype=STATE_DTYPE, device=device)
          for k in ("c", "n", "m", "h")}
    st["m"].fill_(NEG_INF)
    return st


def slstm_state_axes():
    a = ("batch", "inner")
    return {"c": a, "n": a, "m": a, "h": a}


# ---------------------------------------------------------------------------
# the model: (mLSTM, sLSTM) superblocks
# ---------------------------------------------------------------------------
class XLSTMLM:
    """xLSTM LM over a nested dict of parameters, the superblocks stacked
    ``(n_layers / 2, ...)`` as the reference's."""

    def __init__(self, cfg: ModelConfig):
        if cfg.n_layers % 2:
            raise ValueError("xLSTM stacks (mLSTM, sLSTM) pairs: n_layers "
                             f"{cfg.n_layers} is odd")
        self.cfg = cfg
        self.n_super = cfg.n_layers // 2

    # ------------------------------------------------------------------
    # parameter declaration
    # ------------------------------------------------------------------
    def specs(self):
        cfg, ns = self.cfg, self.n_super
        return {
            "embed": layers.embed_spec(cfg),
            "super": {
                "mlstm": mlstm_spec(cfg, stacked=ns),
                "slstm": slstm_spec(cfg, stacked=ns),
            },
            "final_norm": layers.norm_spec(cfg),
            "head": layers.head_spec(cfg),
        }

    def init(self, seed: int = 0, device="cuda",
             dtype: Optional[torch.dtype] = None):
        """Random parameters from ``seed`` on ``device`` (``dtype``
        overrides the config's parameter dtype, e.g. bf16 at load)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.specs(), gen, self.cfg.param_dtype,
                           device=device, dtype=dtype)

    def shapes(self, device="cuda", dtype: Optional[torch.dtype] = None):
        """``torch.empty`` parameter stand-ins (allocation-free under
        ``FakeTensorMode``)."""
        return param_shapes(self.specs(), self.cfg.param_dtype,
                            device=device, dtype=dtype)

    def axes(self):
        return param_axes(self.specs())

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _inputs(self, params, batch, shd):
        tokens = shd.shard(batch["tokens"], ("batch", "seq"))
        return layers.embed(params["embed"], tokens, self.cfg, shd)

    def _logits(self, params, x, shd):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps, shd, ACT)
        return layers.lm_logits(params.get("head"), params["embed"], x,
                                self.cfg, shd)

    def _super_fwd(self, x, sp, shd):
        x, _ = mlstm_block_apply(sp["mlstm"], x, self.cfg, shd)
        x, _ = slstm_apply(sp["slstm"], x, self.cfg, shd)
        return x

    def loss_fn(self, params, batch, shd, remat: Optional[str] = None):
        """``(loss, {"xent", "aux"})`` of ``batch`` (``tokens``,
        ``labels``); every superblock under the ``dots`` policy whatever
        ``remat`` says (the reference's choice)."""
        cfg = self.cfg
        x = self._inputs(params, batch, shd)
        sup = with_remat(lambda c, sp: self._super_fwd(c, sp, shd), "dots")
        for i in range(self.n_super):
            x = sup(x, layer_of(params["super"], i))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps, shd, ACT)
        labels = shd.shard(batch["labels"], ("batch", "seq"))
        loss = layers.chunked_lm_loss(params.get("head"), params["embed"], x,
                                      labels, cfg, shd)
        return loss, {"xent": loss, "aux": torch.zeros(
            (), dtype=torch.float32, device=loss.device)}

    # ------------------------------------------------------------------
    # serving: stacked per-superblock recurrent states, O(1) in length
    # ------------------------------------------------------------------
    def _cache(self, batch, device, make):
        cfg, ns = self.cfg, self.n_super
        d = cfg.d_model

        def stack(shapes):
            return {k: make((ns,) + shape, dtype=STATE_DTYPE, device=device)
                    for k, shape in shapes.items()}

        return {"mlstm": stack(mlstm_state_shapes(cfg, batch)),
                "slstm": stack({k: (batch, d) for k in ("c", "n", "m",
                                                        "h")}),
                "len": make((), dtype=torch.int32, device=device)}

    def init_cache(self, batch: int, max_len: int, device="cuda",
                   dtype: torch.dtype = torch.bfloat16):
        """The reference's ``init_cache``: every leaf zeros (``m`` too: the
        reference stacks zeros of each state's shape), fp32 states;
        ``max_len`` and ``dtype`` are unused (the state is O(1))."""
        return self._cache(batch, device, torch.zeros)

    def cache_shapes(self, batch: int, max_len: int, device="cuda",
                     dtype: torch.dtype = torch.bfloat16):
        """``torch.empty`` cache stand-ins (allocation-free under
        ``FakeTensorMode``)."""
        return self._cache(batch, device, torch.empty)

    def cache_axes(self):
        st = lambda d: {k: ("stack",) + v for k, v in d.items()}  # noqa: E731
        return {"mlstm": st(mlstm_state_axes()),
                "slstm": st(slstm_state_axes()), "len": ()}

    def decode_step(self, params, cache, batch, shd):
        """batch ``{"tokens": (B,1)}`` -> ``(logits (B,1,V), cache)``, the
        cache updated in place."""
        cfg = self.cfg
        x = self._inputs(params, batch, shd)
        for i in range(self.n_super):
            sp = layer_of(params["super"], i)
            mst = layer_of(cache["mlstm"], i)
            sst = layer_of(cache["slstm"], i)
            x, new_m = mlstm_block_apply(sp["mlstm"], x, cfg, shd, state=mst)
            x, new_s = slstm_apply(sp["slstm"], x, cfg, shd, state=sst)
            for name, ax in mlstm_state_axes().items():
                _store(shd, mst[name], new_m[name], ax)
            for name, ax in slstm_state_axes().items():
                _store(shd, sst[name], new_s[name], ax)
        cache["len"].add_(x.shape[1])
        return self._logits(params, x, shd), cache

    def prefill(self, params, batch, shd, max_len: Optional[int] = None):
        """Sequence prefill -> ``(last-token logits (B,V), cache)`` holding
        each superblock's final recurrent states (``max_len`` unused)."""
        cfg = self.cfg
        x = self._inputs(params, batch, shd)
        s = x.shape[1]
        ms, ss = [], []
        for i in range(self.n_super):
            sp = layer_of(params["super"], i)
            x, mst = mlstm_block_apply(sp["mlstm"], x, cfg, shd, state={})
            x, sst = slstm_apply(sp["slstm"], x, cfg, shd)
            ms.append(mst)
            ss.append({k: shd.constraint(t, ax) for (k, t), ax in zip(
                sst.items(), slstm_state_axes().values())})
        cache = {"mlstm": _stack(ms), "slstm": _stack(ss),
                 "len": torch.full((), s, dtype=torch.int32,
                                   device=batch["tokens"].device)}
        logits = self._logits(params, shd.last_position(x), shd)
        return logits[:, 0], cache
