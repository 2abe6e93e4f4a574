"""Static communication lint: anti-pattern findings with modeled savings
(port of ``repro.core.lint``).

The comm matrix says *what* moved; this pass says *what to change*.  Each
rule walks the captures' def-use graphs and/or the per-op
:class:`~repro_torch.core.decompose.CollectiveSchedule`s, and prices its
suggested fix by re-running ``decompose``/``time_split`` under the
alternative -- modeled seconds and DCN bytes, never hand-waved constants.
Every finding keeps the invariant ``0 <= est_savings_s <= est_current_s``
(property-tested): a fix can at best eliminate the op's current modeled
time.

Rules (see :data:`RULES`):

====================  ========  ==================================================
rule id               severity  anti-pattern
====================  ========  ==================================================
small-ar-bucketing    warn      runs of latency-bound all-reduces that should fuse
flat-ring-multipod    error     ring/tree on a pod-spanning group that decomposes
allgather-then-slice  warn      all-gather consumed only through slices
redundant-collective  error     identical collective executed twice, same operands
dcn-permute           warn      DCN-crossing permute with a pod-local device order
wire-dtype-waste      warn      f32 on the wire inside a bf16 producer/consumer
skewed-a2a            warn      irregular all-to-all with a >2x hot rank (straggler)
====================  ========  ==================================================

Entry points: :func:`lint_ops` (module-level),
:meth:`~repro_torch.core.views.CommView.lint` (lazy/memoized per binding)
and ``CommReport.lint_table()``.  Findings serialize in the schema-v7
``lint`` section.

The reference's def-use rules walk the captured HLO modules.  The port has
no compiled module: they walk each capture's dispatch-recorded
:class:`~repro_torch.core.defuse.DefUseGraph` instead (``graphs``, which
every ``MonitorSession`` capture records), whose collective nodes carry the names
of the view's :class:`~repro_torch.core.events.CollectiveOp`s.  The
op-stream rules run on the op stream alone.  Without a topology the
structural rules still fire, with zero modeled savings.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np

from .decompose import (CommPhase, CollectiveSchedule, HIERARCHICAL_KINDS,
                        cached_decompose, hierarchical_decomposition)
from .defuse import CONVERT, SLICE_OPS, DefUseGraph
from .events import CollectiveOp, Shape
from .topology import MeshTopology

SEVERITIES = ("info", "warn", "error")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


def severity_rank(severity: str) -> int:
    """info < warn < error (for ``--fail-on`` thresholds and sorting)."""
    return _SEV_RANK[severity]


@dataclasses.dataclass
class LintFinding:
    """One priced anti-pattern instance.

    ``est_current_s`` is the modeled time of the flagged op(s) as
    captured; ``est_savings_s`` the modeled delta to the suggested
    alternative (both execution-weighted, clamped to the invariant
    ``0 <= est_savings_s <= est_current_s``).  ``est_dcn_bytes_saved``
    prices the DCN-traffic delta the same way.
    """

    rule_id: str
    severity: str                  # "info" | "warn" | "error"
    op_names: list[str]
    phase: str
    message: str
    est_savings_s: float = 0.0
    est_dcn_bytes_saved: float = 0.0
    suggested_fix: str = ""
    est_current_s: float = 0.0

    def to_dict(self) -> dict:
        return {
            "rule_id": self.rule_id,
            "severity": self.severity,
            "op_names": list(self.op_names),
            "phase": self.phase,
            "message": self.message,
            "est_savings_s": float(self.est_savings_s),
            "est_dcn_bytes_saved": float(self.est_dcn_bytes_saved),
            "suggested_fix": self.suggested_fix,
            "est_current_s": float(self.est_current_s),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LintFinding":
        return cls(
            rule_id=d["rule_id"],
            severity=d["severity"],
            op_names=list(d.get("op_names", [])),
            phase=d.get("phase", ""),
            message=d.get("message", ""),
            est_savings_s=float(d.get("est_savings_s", 0.0)),
            est_dcn_bytes_saved=float(d.get("est_dcn_bytes_saved", 0.0)),
            suggested_fix=d.get("suggested_fix", ""),
            est_current_s=float(d.get("est_current_s", 0.0)),
        )


def max_severity(findings: Iterable[LintFinding]) -> Optional[str]:
    """Highest severity present (None for an empty list)."""
    best = None
    for f in findings:
        if best is None or severity_rank(f.severity) > severity_rank(best):
            best = f.severity
    return best


# ---------------------------------------------------------------------------
# Rule context: ops + topology + module indexes, with shared pricing.
# ---------------------------------------------------------------------------
class LintContext:
    """Everything a rule reads: the op stream of one view binding, its
    topology/algorithm, and the captures' def-use graphs."""

    def __init__(self, ops, topo: Optional[MeshTopology],
                 algorithm: str, graphs: Iterable[DefUseGraph]):
        self.ops: list[CollectiveOp] = list(ops)
        self.topo = topo
        self.algorithm = algorithm
        self.graphs = [g for g in graphs if g is not None]
        self._op_ids = {id(op) for op in self.ops}

    def collectives(self, graph: DefUseGraph):
        """``(node, op)`` for each collective node of ``graph`` whose op
        (found by the name the node carries, among its own capture's ops)
        is in this view, so phase-filtered views lint only their ops and
        findings inherit weight/phase from the analyzed stream."""
        for node in graph.collective_nodes:
            op = graph.ops_by_name.get(node.collective)
            if op is not None and id(op) in self._op_ids:
                yield node, op

    # -- pricing (one execution; callers apply op.weight) -------------------
    def op_time(self, op: CollectiveOp, algorithm: Optional[str] = None, *,
                include_latency: bool = True) -> float:
        if self.topo is None:
            return 0.0
        # memoized: a rule pricing its suggested alternative re-decomposes
        # the same shapes the capture already decomposed
        sched = cached_decompose(op, algorithm or self.algorithm, self.topo,
                                 warn=False)
        ici, dcn = sched.time_split(self.topo,
                                    include_latency=include_latency)
        return ici + dcn

    def sched_time(self, sched: CollectiveSchedule) -> float:
        if self.topo is None:
            return 0.0
        ici, dcn = sched.time_split(self.topo)
        return ici + dcn

    def dcn_bytes(self, op: CollectiveOp,
                  algorithm: Optional[str] = None) -> float:
        if self.topo is None:
            return 0.0
        sched = cached_decompose(op, algorithm or self.algorithm, self.topo,
                                 warn=False)
        return sum(ph.total_send_bytes() for ph in sched.phases
                   if ph.tier == "dcn")


def _clamp(savings: float, current: float) -> tuple[float, float]:
    """Enforce the finding invariant 0 <= savings <= current."""
    current = max(0.0, float(current))
    return min(max(0.0, float(savings)), current), current


# ---------------------------------------------------------------------------
# Rule 1: small-collective bucketing.
# ---------------------------------------------------------------------------
def _rule_small_ar_bucketing(ctx: LintContext) -> list[LintFinding]:
    """Consecutive latency-bound all-reduces over the same groups should
    fuse into one bucket: each op below the bandwidth crossover pays the
    full per-hop latency chain for a few bytes, and one fused op pays it
    once.  Priced as sum-of-current minus the fused op's modeled time."""
    if ctx.topo is None:
        return []
    findings: list[LintFinding] = []
    run: list[CollectiveOp] = []

    def flush():
        if len(run) < 2:
            run.clear()
            return
        ops = list(run)
        run.clear()
        # latency-bound: the per-hop latency term dominates the bandwidth
        # term (full time at least twice the latency-free time)
        for op in ops:
            t_full = ctx.op_time(op)
            if t_full <= 0.0 or t_full < 2.0 * ctx.op_time(
                    op, include_latency=False):
                return
        w = max(1.0, ops[0].weight)
        current = sum(ctx.op_time(op) for op in ops) * w
        fused = dataclasses.replace(
            ops[0],
            name=f"fused({ops[0].name}..{ops[-1].name})",
            result_shapes=[s for op in ops for s in op.result_shapes])
        fused_t = ctx.op_time(fused) * w
        savings, current = _clamp(current - fused_t, current)
        dcn_cur = sum(ctx.dcn_bytes(op) for op in ops) * w
        dcn_saved = max(0.0, dcn_cur - ctx.dcn_bytes(fused) * w)
        total_bytes = sum(op.result_bytes for op in ops)
        findings.append(LintFinding(
            rule_id="small-ar-bucketing", severity="warn",
            op_names=[op.name for op in ops], phase=ops[0].phase,
            message=(f"{len(ops)} consecutive latency-bound all-reduces "
                     f"({total_bytes} B total) over the same replica "
                     "groups; each pays the full latency chain for a "
                     "sub-crossover payload"),
            est_savings_s=savings, est_dcn_bytes_saved=dcn_saved,
            est_current_s=current,
            suggested_fix=("fuse into one bucketed all-reduce (e.g. "
                           "ddp.allreduce_bucketed / larger bucket_mb) so "
                           "the latency chain is paid once per bucket"),
        ))

    prev_key = None
    for op in ctx.ops:
        key = (op.kind, op.phase, repr(op.replica_groups), op.weight)
        if op.kind != "all-reduce":
            flush()
            prev_key = None
            continue
        if key != prev_key:
            flush()
        run.append(op)
        prev_key = key
    flush()
    return findings


# ---------------------------------------------------------------------------
# Rule 2: flat ring/tree on a multi-pod group that decomposes.
# ---------------------------------------------------------------------------
def _rule_flat_ring_multipod(ctx: LintContext) -> list[LintFinding]:
    """A pod-spanning replica group bound to ring/tree where the shared
    hierarchical predicate holds sends the whole payload across DCN;
    priced current-vs-hierarchical via the schedule engine."""
    if ctx.topo is None or ctx.algorithm == "hierarchical":
        return []
    findings = []
    for op in ctx.ops:
        if op.kind not in HIERARCHICAL_KINDS:
            continue
        if not any(hierarchical_decomposition(op.kind, g, ctx.topo)
                   for g in op.replica_groups):
            continue
        w = max(1.0, op.weight)
        current = ctx.op_time(op) * w
        hier = ctx.op_time(op, "hierarchical") * w
        savings, current = _clamp(current - hier, current)
        if savings <= 0.0:
            continue
        dcn_saved = max(0.0, (ctx.dcn_bytes(op)
                              - ctx.dcn_bytes(op, "hierarchical")) * w)
        findings.append(LintFinding(
            rule_id="flat-ring-multipod", severity="error",
            op_names=[op.name], phase=op.phase,
            message=(f"{op.kind} over {op.group_size} ranks spans "
                     f"{ctx.topo.num_pods} pods under "
                     f"{ctx.algorithm!r}: the flat schedule streams the "
                     "full payload over DCN where a hierarchical "
                     "intra-pod + cross-pod decomposition exists"),
            est_savings_s=savings, est_dcn_bytes_saved=dcn_saved,
            est_current_s=current,
            suggested_fix=("bind algorithm='hierarchical' (pod-local "
                           "reduce/gather + cross-pod shard exchange)"),
        ))
    return findings


# ---------------------------------------------------------------------------
# Rule 3: all-gather consumed only through slices.
# ---------------------------------------------------------------------------
def _rule_allgather_then_slice(ctx: LintContext) -> list[LintFinding]:
    """An all-gather whose every effective consumer is a slice
    (:data:`~repro_torch.core.defuse.SLICE_OPS`) materializes the full
    gathered tensor to keep a fraction: the slice could move before the
    collective (sharded compute, or reduce-scatter when the producer is a
    reduction).  Priced as the all-gather's current time minus an
    all-gather of only the consumed bytes."""
    findings = []
    for graph in ctx.graphs:
        for node, op in ctx.collectives(graph):
            if op.kind != "all-gather":
                continue
            users = graph.effective_users(node.name)
            if not users:
                continue
            if not all(opc in SLICE_OPS for _, opc in users):
                continue
            consumed = sum(graph.result_bytes(u)
                           for u in {u for u, _ in users})
            if consumed <= 0 or consumed >= op.result_bytes:
                continue
            w = max(1.0, op.weight)
            current = ctx.op_time(op) * w
            alt = dataclasses.replace(
                op, result_shapes=[Shape("u8", (int(consumed),))])
            savings, current = _clamp(current - ctx.op_time(alt) * w,
                                      current)
            dcn_saved = max(0.0, (ctx.dcn_bytes(op)
                                  - ctx.dcn_bytes(alt)) * w)
            findings.append(LintFinding(
                rule_id="allgather-then-slice", severity="warn",
                op_names=[op.name], phase=op.phase,
                message=(f"all-gather of {op.result_bytes} B is "
                         "consumed only through "
                         f"{sorted({o for _, o in users})} keeping "
                         f"{consumed} B; the full gather is wasted "
                         "wire traffic"),
                est_savings_s=savings, est_dcn_bytes_saved=dcn_saved,
                est_current_s=current,
                suggested_fix=("shard the consumer (keep compute on "
                               "the local shard) or use "
                               "reduce-scatter / a smaller gather of "
                               "just the consumed region"),
            ))
    return findings


# ---------------------------------------------------------------------------
# Rule 4: redundant collective (same kind, operands, groups).
# ---------------------------------------------------------------------------
def _rule_redundant_collective(ctx: LintContext) -> list[LintFinding]:
    """Two collectives with identical operands, replica groups and
    attributes inside one capture compute the same value twice: the
    def-use record is SSA (a write makes a new value), so the shared
    operand cannot have been rewritten in between.  Priced as (k-1)
    executions of the duplicate."""
    findings = []
    for graph in ctx.graphs:
        groups: dict[tuple, list[CollectiveOp]] = {}
        for node, op in ctx.collectives(graph):
            if not node.operands:
                continue
            # channel_id deliberately excluded: two channels moving
            # the same operands over the same groups are still the
            # same transfer
            key = (op.kind, tuple(node.operands),
                   repr(op.replica_groups),
                   repr(op.dimensions),
                   repr(op.source_target_pairs),
                   op.use_global_device_ids)
            groups.setdefault(key, []).append(op)
        for key, dupes in groups.items():
            if len(dupes) < 2:
                continue
            k = len(dupes)
            w = max(1.0, dupes[0].weight)
            per_exec = ctx.op_time(dupes[0]) * w
            current = per_exec * k
            savings, current = _clamp(per_exec * (k - 1), current)
            dcn_saved = max(
                0.0, ctx.dcn_bytes(dupes[0]) * w * (k - 1))
            findings.append(LintFinding(
                rule_id="redundant-collective", severity="error",
                op_names=[op.name for op in dupes],
                phase=dupes[0].phase,
                message=(f"{k} identical {dupes[0].kind} ops over "
                         f"operands {list(key[1])} with the same "
                         "replica groups and no intervening writer "
                         "(SSA): the transfer runs "
                         f"{k}x for one value"),
                est_savings_s=savings, est_dcn_bytes_saved=dcn_saved,
                est_current_s=current,
                suggested_fix=("deduplicate at the source (reuse the "
                               "first result; check for repeated "
                               "psum/all_gather calls on the same "
                               "value across the step)"),
            ))
    return findings


# ---------------------------------------------------------------------------
# Rule 5: DCN-crossing permute with an intra-pod alternative.
# ---------------------------------------------------------------------------
def _components(pairs: list[tuple[int, int]]) -> list[list[int]]:
    """Connected components of the permute's communication graph: every
    device set that must share a pod for the permute to stay on ICI."""
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in pairs:
        parent.setdefault(a, a)
        parent.setdefault(b, b)
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    comps: dict[int, list[int]] = {}
    for d in parent:
        comps.setdefault(find(d), []).append(d)
    return [sorted(c) for c in comps.values()]


def _rule_dcn_permute(ctx: LintContext) -> list[LintFinding]:
    """A collective-permute whose pairs cross pods is billed on DCN, but
    when the permutation's connected device sets each fit inside a pod
    (first-fit packed into the pod capacity), a different device order
    keeps every hop on ICI.  Priced current-vs-all-pairs-on-ICI."""
    topo = ctx.topo
    if topo is None or topo.num_pods <= 1:
        return []
    findings = []
    cap = topo.devices_per_pod
    for op in ctx.ops:
        if op.kind != "collective-permute" or not op.source_target_pairs:
            continue
        if not any(topo.pod_index(a) != topo.pod_index(b)
                   for a, b in op.source_target_pairs):
            continue
        comps = _components(op.source_target_pairs)
        # first-fit decreasing into num_pods bins of pod capacity: does a
        # device reordering exist that keeps each component pod-local?
        bins = [0] * topo.num_pods
        feasible = True
        for comp in sorted(comps, key=len, reverse=True):
            if len(comp) > cap:
                feasible = False
                break
            for i, used in enumerate(bins):
                if used + len(comp) <= cap:
                    bins[i] = used + len(comp)
                    break
            else:
                feasible = False
                break
        if not feasible:
            continue
        w = max(1.0, op.weight)
        current = ctx.op_time(op) * w
        alt = CollectiveSchedule(op.kind, ctx.algorithm, [CommPhase(
            kind=op.kind, tier="ici", groups=None,
            bytes_per_rank=float(op.result_bytes), latency_hops=1.0,
            structure="pairs",
            payload=float(op.result_bytes) * op.num_groups,
            pairs=np.asarray(op.source_target_pairs, dtype=np.intp))])
        savings, current = _clamp(current - ctx.sched_time(alt) * w,
                                  current)
        if savings <= 0.0:
            continue
        n_cross = sum(1 for a, b in op.source_target_pairs
                      if topo.pod_index(a) != topo.pod_index(b))
        findings.append(LintFinding(
            rule_id="dcn-permute", severity="warn",
            op_names=[op.name], phase=op.phase,
            message=(f"collective-permute routes {n_cross} of "
                     f"{len(op.source_target_pairs)} pairs across DCN, "
                     "but its communicating device sets each fit inside "
                     "one pod -- a pod-local device order keeps every "
                     "hop on ICI"),
            est_savings_s=savings,
            est_dcn_bytes_saved=max(0.0, ctx.dcn_bytes(op) * w),
            est_current_s=current,
            suggested_fix=("reorder the mesh's device assignment (or the "
                           "permute axis layout) so communicating ranks "
                           "share a pod"),
        ))
    return findings


# ---------------------------------------------------------------------------
# Rule 6: f32 on the wire inside a bf16 chain.
# ---------------------------------------------------------------------------
def _rule_wire_dtype_waste(ctx: LintContext) -> list[LintFinding]:
    """A collective moving f32 whose producers are bf16->f32 converts, or
    whose every effective consumer converts straight back to bf16, sends
    double the bytes the computation needs.  (XLA:CPU's own f32 promotion
    of bf16 all-reduces is already accounted at bf16 by the parser and is
    not flagged.)  Priced against the same op at bf16 width."""
    findings = []
    for graph in ctx.graphs:
        for node, op in ctx.collectives(graph):
            if not any(s.dtype == "f32" for s in op.result_shapes):
                continue
            prods = [graph.producer_of(o) for o in node.operands]
            prod_bf16 = bool(prods) and all(
                p is not None and p.opcode == CONVERT and p.operands
                and graph.value_dtype(p.operands[0]) == "bf16"
                for p in prods)
            users = graph.effective_users(node.name)
            cons_bf16 = bool(users) and all(
                opc == CONVERT and graph.result_dtype(u) == "bf16"
                for u, opc in users)
            if not (prod_bf16 or cons_bf16):
                continue
            w = max(1.0, op.weight)
            current = ctx.op_time(op) * w
            alt = dataclasses.replace(op, result_shapes=[
                Shape("bf16", s.dims) if s.dtype == "f32" else s
                for s in op.result_shapes])
            savings, current = _clamp(current - ctx.op_time(alt) * w,
                                      current)
            dcn_saved = max(0.0, (ctx.dcn_bytes(op)
                                  - ctx.dcn_bytes(alt)) * w)
            side = ("producers are bf16->f32 converts" if prod_bf16
                    else "every consumer converts back to bf16")
            findings.append(LintFinding(
                rule_id="wire-dtype-waste", severity="warn",
                op_names=[op.name], phase=op.phase,
                message=(f"{op.kind} moves {op.result_bytes} B of "
                         f"f32 but {side}: the wire width is double "
                         "what the computation keeps"),
                est_savings_s=savings, est_dcn_bytes_saved=dcn_saved,
                est_current_s=current,
                suggested_fix=("run the collective at bf16 (convert "
                               "before, not after), halving wire "
                               "bytes"),
            ))
    return findings


# ---------------------------------------------------------------------------
# Rule 7: skewed all-to-all (hot-rank straggler).
# ---------------------------------------------------------------------------
_SKEW_THRESHOLD = 2.0
_A2A_LINT_KINDS = ("all-to-all", "ragged-all-to-all")


def _rule_skewed_a2a(ctx: LintContext) -> list[LintFinding]:
    """An irregular all-to-all whose max per-rank bytes exceed twice the
    mean is straggler-bound: every phase completes when its hottest rank
    does, so the collective runs at the hot rank's time while the other
    ranks idle.  Priced as the op's current (max-billed) modeled time
    minus the same op with its bytes rebalanced to the mean -- i.e. the
    time a load-balanced routing (capacity-factor cap, expert replication,
    or re-sharding the hot expert) would achieve with the same total
    payload."""
    if ctx.topo is None:
        return []
    findings = []
    for op in ctx.ops:
        if op.kind not in _A2A_LINT_KINDS:
            continue
        skew = op.skew()
        if skew <= _SKEW_THRESHOLD:
            continue
        vec = op.byte_vector()
        if vec is None:
            continue
        n = int(vec.size)
        w = max(1.0, op.weight)
        current = ctx.op_time(op) * w
        balanced = dataclasses.replace(
            op, bytes_per_rank_vec=[float(vec.sum()) / n] * n)
        savings, current = _clamp(current - ctx.op_time(balanced) * w,
                                  current)
        if savings <= 0.0:
            continue
        dcn_saved = max(0.0, (ctx.dcn_bytes(op)
                              - ctx.dcn_bytes(balanced)) * w)
        hot = int(np.argmax(vec))
        findings.append(LintFinding(
            rule_id="skewed-a2a", severity="warn",
            op_names=[op.name], phase=op.phase,
            message=(f"{op.kind} over {op.group_size} ranks is "
                     f"{skew:.2f}x skewed (rank {hot} sends "
                     f"{float(vec[hot]):.0f} B vs {float(vec.mean()):.0f} B "
                     "mean): the schedule completes at the hot rank's "
                     "pace while the rest idle"),
            est_savings_s=savings, est_dcn_bytes_saved=dcn_saved,
            est_current_s=current,
            suggested_fix=("rebalance the routing (capacity-factor cap, "
                           "replicate the hot expert, or re-shard it "
                           "across ranks) so per-rank bytes approach the "
                           "mean"),
        ))
    return findings


# ---------------------------------------------------------------------------
# Registry and entry point.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LintRule:
    """One registered rule (the registry is the docs' rule table)."""

    rule_id: str
    severity: str
    title: str
    fn: Callable[[LintContext], list[LintFinding]]


RULES: tuple[LintRule, ...] = (
    LintRule("small-ar-bucketing", "warn",
             "latency-bound all-reduce run should fuse into one bucket",
             _rule_small_ar_bucketing),
    LintRule("flat-ring-multipod", "error",
             "pod-spanning group on ring/tree where hierarchical holds",
             _rule_flat_ring_multipod),
    LintRule("allgather-then-slice", "warn",
             "all-gather consumed only through slice/dynamic-slice",
             _rule_allgather_then_slice),
    LintRule("redundant-collective", "error",
             "identical collective executed more than once per value",
             _rule_redundant_collective),
    LintRule("dcn-permute", "warn",
             "DCN-crossing permute with a pod-local device order",
             _rule_dcn_permute),
    LintRule("wire-dtype-waste", "warn",
             "f32 on the wire inside a bf16 producer/consumer chain",
             _rule_wire_dtype_waste),
    LintRule("skewed-a2a", "warn",
             "irregular all-to-all with a >2x hot rank (straggler-bound)",
             _rule_skewed_a2a),
)


def lint_ops(ops, topo: Optional[MeshTopology] = None,
             algorithm: str = "ring",
             graphs: Iterable[DefUseGraph] = ()) -> list[LintFinding]:
    """Run every registered rule over one ``(ops, algorithm, topo)``
    binding; findings sorted errors-first, then by modeled savings.

    ``graphs`` (the captures' def-use graphs, one per capture) enable the
    def-use rules; without a topology the structural rules still run but
    every modeled figure is zero.
    """
    ctx = LintContext(ops, topo, algorithm, graphs)
    findings: list[LintFinding] = []
    for rule in RULES:
        findings.extend(rule.fn(ctx))
    findings.sort(key=lambda f: (-severity_rank(f.severity),
                                 -f.est_savings_s, f.rule_id, f.op_names))
    return findings
