"""Mixture-of-Experts block (port of ``repro.models.moe``): a top-k router
and a capacity-bounded dense dispatch.

GShard/Switch-style dispatch, the reference's arithmetic kept:

* tokens are grouped (``MOE_GROUP``; a sequence it does not divide is one
  group), so the dispatch tensor is ``tokens x E x C_group`` with
  ``C_group = max(4, ceil(cf * k * group / E))``;
* the router runs in fp32: softmax, then top-k, renormalised when
  ``k > 1``; positions in an expert are counted choice-major, so a token's
  first choice is never dropped for another token's second; a choice at
  a position ``>= C`` is dropped;
* each expert is a SwiGLU (``wi`` gate-then-up along its last dim);
* the auxiliary loss is ``0.01 * load balance + 0.001 * router z-loss``.

The reference's einsums are batched matrix products here (``torch.bmm``
over the experts: one product per expert over contiguous ``(E, d, 2f)``
and ``(E, f, d)`` weights, which are never copied).  Every expert computes
its ``C`` slots whether or not a token landed there, as in the reference.

On a mesh the block runs on local shards in two steps
(:meth:`~repro_torch.parallel.Sharder.local`), since DTensor cannot lay
out the dispatch products itself (their reshapes merge the data-sharded
batch with the model-sharded experts): routing, dispatch and the ``wi``
product, then the ``wo`` product and the combine.  The weights are read
as ``("expert", None, "mlp")`` / ``("expert", "mlp", None)`` -- the FSDP
gather over ``data`` -- so either the experts are sharded over ``model``
(EP: each rank computes its own experts) or, where the model axis does not
divide them, the hidden dim is (TP-experts: the gate and up halves are
gathered between the two steps, as the dense MLP's are).  The output is
then a per-rank share of the sum over experts, reduced by
the final ``("batch", "seq", None)`` layout.  (Each shard's share leaves
its local step on a leading dim of its own and is summed there by DTensor:
a ``Partial`` output of the local step would halve the gradients.)  Routing runs on every model
rank of a batch shard alike; its statistics for the auxiliary loss are
sums over the rank's rows, reduced over the batch shards.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import spans

from .common import ModelConfig, Spec

MOE_GROUP = 512  # tokens per dispatch group


def moe_spec(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    return {
        "router": Spec(lead + (d, e), lx + ("embed", "expert"), scale=0.1),
        "wi": Spec(lead + (e, d, 2 * f), lx + ("expert", "embed", "mlp")),
        "wo": Spec(lead + (e, f, d), lx + ("expert", "mlp", "embed")),
    }


def group_capacity(cfg: ModelConfig, group: int = MOE_GROUP) -> int:
    c = math.ceil(cfg.capacity_factor * cfg.top_k * group / cfg.n_experts)
    return max(4, c)


def route(xg, router, k: int):
    """The fp32 router over token groups: ``xg`` (b, G, s, d), ``router``
    (d, e) -> ``(logits, probs, gate_vals, gate_idx)``, the last two
    (b, G, s, k) in descending order of probability."""
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    if k > 1:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    return logits, probs, gate_vals, gate_idx


def dispatch_tensors(gate_vals, gate_idx, e: int, c: int):
    """Choice-major positions in each expert -> fp32 ``(dispatch, combine,
    sel_sum)``: (b, G, s, e, c) one-hot slots of the kept choices, the same
    weighted by their gates, and (b, G, s, e) the choices made.  A one-hot
    row is built by comparison, so a dropped position (``>= c``) gives a
    zero row, as ``jax.nn.one_hot`` does."""
    b, ng, s, k = gate_idx.shape
    dev = gate_vals.device
    experts = torch.arange(e, device=dev)
    slots = torch.arange(c, device=dev, dtype=torch.float32)
    counts = torch.zeros((b, ng, e), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((b, ng, s, e, c), dtype=torch.float32, device=dev)
    combine = torch.zeros_like(dispatch)
    sel_sum = torch.zeros((b, ng, s, e), dtype=torch.float32, device=dev)
    for ki in range(k):
        sel_k = (gate_idx[..., ki, None] == experts).float()
        pos_k = torch.cumsum(sel_k, dim=2) - sel_k + counts[:, :, None, :]
        keep_k = sel_k * (pos_k < c)
        counts = counts + sel_k.sum(dim=2)
        oh = (pos_k[..., None] == slots).float() * keep_k[..., None]
        dispatch = dispatch + oh
        combine = combine + gate_vals[..., ki, None, None] * oh
        sel_sum = sel_sum + sel_k
    return dispatch, combine, sel_sum


def _dispatch_in(x, router, wi, *, cfg: ModelConfig, group: int, c: int,
                 e0: int, with_aux: bool, share: int = 1):
    """Routing, dispatch and the ``wi`` product on one shard: ``x`` (b, s,
    d), ``wi`` the shard's experts ``[e0, e0 + e_loc)`` (all of them,
    or a slice of the hidden dim).  Returns ``h`` (e_loc, b*G*c, 2f_loc),
    the shard's combine weights (b, G, s, e_loc, c) and, with
    ``with_aux``, the routing sums over its rows: choices per expert,
    probability per expert and the squared log-sum-exp, ``(1, 2e + 1)``
    (a leading dim the shards stack along), divided by ``share``: the
    number of model ranks that route the same rows and stack their sums
    too, so that each one's gradient is its share."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    ng = s // group
    dt = x.dtype
    e_loc = wi.shape[0]
    with spans.span("moe.dispatch"):
        xg = x.reshape(b, ng, group, d)
        logits, probs, gate_vals, gate_idx = route(xg, router, k)
        dispatch, combine, sel_sum = dispatch_tensors(gate_vals, gate_idx,
                                                      e, c)
        dispatch = dispatch[..., e0:e0 + e_loc, :]
        combine = combine[..., e0:e0 + e_loc, :]
        # "bGsec,bGsd->beGcd", then the experts first
        disp = dispatch.to(dt).reshape(b * ng, group, e_loc * c)
        xin = torch.bmm(disp.transpose(1, 2), xg.reshape(b * ng, group, d))
        xin = xin.reshape(b * ng, e_loc, c, d).transpose(0, 1).reshape(
            e_loc, b * ng * c, d)
        if with_aux:
            lse2 = (torch.logsumexp(logits, dim=-1) ** 2).sum()[None]
            stats = torch.cat([sel_sum.sum(dim=(0, 1, 2)),
                               probs.sum(dim=(0, 1, 2)), lse2])[None] / share
    with spans.span("moe.experts"):
        h = torch.bmm(xin, wi.to(dt))                  # "beGcd,edF->beGcF"
    return (h, combine, stats) if with_aux else (h, combine)


def _combine_out(act, wo, combine):
    """The ``wo`` product and the combine on one shard: ``act`` (e_loc,
    b*G*c, f_loc), ``wo`` (e_loc, f_loc, d), ``combine`` (b, G, s, e_loc,
    c) -> (1, b, G*s, d), the shard's share of the sum over experts (a
    leading dim the shards stack along)."""
    b, ng, group, e_loc, c = combine.shape
    dt = act.dtype
    out = torch.bmm(act, wo.to(dt))                    # "beGcf,efd->beGcd"
    d = out.shape[-1]
    out = out.reshape(e_loc, b * ng, c, d).transpose(0, 1).reshape(
        b * ng, e_loc * c, d)
    y = torch.bmm(combine.to(dt).reshape(b * ng, group, e_loc * c), out)
    return y.reshape(1, b, ng * group, d)              # "beGcd,bGsec->bGsd"


def _aux_loss(stats, n_rows: int, e: int):
    """The reference's aux loss from the summed routing statistics over
    ``n_rows`` tokens: Switch load balance and router z-loss."""
    frac_tokens = stats[:e] / n_rows
    frac_probs = stats[e:2 * e] / n_rows
    lb_loss = e * (frac_tokens * frac_probs).sum()
    z_loss = stats[2 * e] / n_rows
    return 0.01 * lb_loss + 0.001 * z_loss


def _placements(shd, x, wi, wo):
    """The mesh-dim placements of the two local steps' operands and
    outputs: ``x``'s batch shards, the weights' expert or hidden shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    x_pl = shd.placements(x.shape, ("batch", None, None))
    wi_pl = shd.placements(wi.shape, ("expert", None, "mlp"))
    wo_pl = shd.placements(wo.shape, ("expert", "mlp", None))
    batch = [isinstance(p, Shard) for p in x_pl]
    # mesh dims that split the experts' work (experts or hidden columns)
    split = [isinstance(a, Shard) or isinstance(b, Shard)
             for a, b in zip(wi_pl, wo_pl)]
    r = Replicate()

    def grad(pl):
        """An input's gradient: partial over the dims whose ranks do
        different work on it."""
        return [Partial() if p == r and (bt or sp) else p
                for p, bt, sp in zip(pl, batch, split)]

    combine = [Shard(0) if bt else (Shard(3) if wp == Shard(0) else r)
               for bt, wp in zip(batch, wi_pl)]
    return dict(
        wi=wi_pl, combine=combine,
        grad_a=[grad(x_pl), grad([r] * len(x_pl)), grad(wi_pl)],
        # combine's gradient stays each rank's share (declared as its
        # forward placement, so it is not reduced): the routing behind it
        # hands its share on to router and x, whose gradients are reduced
        grad_b=[None, grad(wo_pl), None],
        share=math.prod(n for n, sp in zip(shd.mesh.shape, split) if sp),
        # h (e, b*G*c, 2f): batch rows, then the wi shard's experts or
        # hidden columns
        h=[Shard(1) if bt else wp for bt, wp in zip(batch, wi_pl)],
        # stats (1, 2e+1): a batch shard's, each work-splitting rank's share
        stats=[Shard(0) if bt or sp else r for bt, sp in zip(batch, split)],
        # act (e, b*G*c, f) as wo's rows take it
        act=[Shard(1) if bt else (Shard(2) if wp == Shard(1) else wp)
             for bt, wp in zip(batch, wo_pl)],
        # y (1, b, s, d): batch rows, each weight shard's share
        y=[Shard(1) if bt else (Shard(0) if isinstance(wp, Shard) else r)
           for bt, wp in zip(batch, wo_pl)])


def moe_block(params, x, cfg: ModelConfig, shd, group: int = MOE_GROUP,
              with_aux: bool = True):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar fp32).  With
    ``with_aux=False`` (serving, which discards it, as the reference's
    compiled steps drop it) the routing statistics are not reduced and
    ``aux`` is None."""
    with spans.span("moe"):
        return _moe_block(params, x, cfg, shd, group, with_aux)


def _moe_block(params, x, cfg: ModelConfig, shd, group: int, with_aux: bool):
    b, s, d = x.shape
    e = cfg.n_experts
    if s % group != 0:
        group = s                                          # tiny smoke configs
    c = group_capacity(cfg, group)
    router, wi, wo = params["router"], params["wi"], params["wo"]
    kw = dict(cfg=cfg, group=group, c=c, with_aux=with_aux)

    if shd.mesh is None:
        out = _dispatch_in(x, router, wi, e0=0, **kw)
        with spans.span("moe.experts"):
            gate, up = torch.chunk(out[0], 2, dim=-1)
            y = _combine_out(F.silu(gate) * up, wo, out[1])[0]
        aux = _aux_loss(out[2][0], b * s, e) if with_aux else None
        return y, aux

    from torch.distributed.tensor import Shard

    pl = _placements(shd, x, wi, wo)
    # the rank's first expert: its coordinate on the mesh dim that shards
    # the experts (EP), else 0
    ep = [i for i, p in enumerate(pl["wi"]) if p == Shard(0)]
    e_loc = e // math.prod(shd.mesh.shape[i] for i in ep)
    e0 = shd.mesh.get_local_rank(ep[0]) * e_loc if ep else 0
    outs = [pl["h"], pl["combine"]] + ([pl["stats"]] if with_aux else [])
    res = shd.local(
        lambda x_, r_, w_: _dispatch_in(x_, r_, w_, e0=e0,
                                        share=pl["share"], **kw),
        (x, router, wi), (("batch", None, None), (None, None),
                          ("expert", None, "mlp")),
        out_placements=tuple(outs), grad_placements=pl["grad_a"])
    with spans.span("moe.experts"):
        # gate and up: gathered along the hidden dim where it is sharded
        gate, up = torch.chunk(res[0], 2, dim=-1)
        act = (F.silu(gate) * up).redistribute(shd.mesh, pl["act"])
        # the shards' shares stacked along a leading dim and summed there:
        # DTensor's own sum (a Partial over the shards), whose backward
        # hands each shard the whole gradient
        y = shd.local(_combine_out, (act, wo, res[1]),
                      (None, ("expert", "mlp", None), None),
                      out_placements=pl["y"],
                      grad_placements=pl["grad_b"]).sum(dim=0)
    aux = None
    if with_aux:
        aux = _aux_loss(shd.constraint(res[2].sum(dim=0), (None,)), b * s, e)
    return shd.constraint(y, ("batch", "seq", None)), aux
