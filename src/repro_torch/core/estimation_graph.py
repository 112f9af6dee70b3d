"""Estimation-plan optimization over the index/deduction graph (paper §5).

Given target compressed indexes, a tolerable error e and confidence q, choose
for each index either SampleCF (costly, accurate) or a deduction (free, less
accurate) plus a single sampling fraction f, minimizing total estimation cost
subject to: P(|relative error| within e) >= q for every target.

The paper's greedy algorithm (§5.2 pseudocode) runs on the batched
`planner_engine.PlannerEngine`, which scores every sampling fraction in one
pass over a shared deduction graph; plans are then executed with the
batched SampleCF `EstimationEngine` (`execute_cached` estimates only the
(NodeKey, f) misses of an online session's cache).  `greedy` runs the
engine at one fraction, and `optimal` is the exponential Optimal
recursion of Appendix D (host Python; the paper's quality yardstick,
Table 4), which falls back to `greedy` where no plan meets the bound.

Beside each batched path stands its statement-at-a-time oracle, float64
Python on the host: `greedy_scalar` scores each (target, candidate) pair
on its own (`EstimationPlanner(use_engine=False)` routes `greedy`, `plan`
and `plan_all_sampled` through it), and `execute_scalar` runs one
`samplecf.sample_cf` per SAMPLED node.  The batched paths' numpy
backend is plan-identical and byte-identical to them.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Dict, List, MutableMapping, Optional, Sequence, Tuple

from . import deduction as ded
from . import errors as err
from .compression import METHODS
from .estimation_engine import EstimationEngine
from .relation import IndexDef, Table, uncompressed_pages
from .samplecf import SampleManager, SizeEstimate, sample_cf

F_GRID = (0.01, 0.025, 0.05, 0.075, 0.10)

# q strictly above any probability: every deduction fails the constraint, so
# greedy degenerates to SampleCF-on-everything (the paper's "All" baseline).
FORCE_ALL_Q = 1.1


class State(enum.Enum):
    NONE = "NONE"
    DEDUCED = "DEDUCED"
    SAMPLED = "SAMPLED"
    EXACT = "EXACT"  # existing index: true size known from catalog (§5.1)


@dataclasses.dataclass(frozen=True)
class NodeKey:
    table: str
    cols: Tuple[str, ...]
    method: str

    def __hash__(self) -> int:
        # NodeKeys are hashed millions of times per greedy run; cache the
        # field-tuple hash on first use (frozen blocks plain assignment).
        # Plain attribute access beats __dict__.get by ~5x and this IS a
        # measured hot path (every dict op on plans/universes lands here).
        try:
            return self._hash
        except AttributeError:
            h = hash((self.table, self.cols, self.method))
            object.__setattr__(self, "_hash", h)
            return h

    def gkey(self) -> Tuple[str, frozenset, str]:
        """ColSet-group key (table, column SET, method), cached — the
        planner engine's per-round group pass would otherwise rebuild
        the frozenset for every target every round."""
        try:
            return self._gkey
        except AttributeError:
            g = (self.table, frozenset(self.cols), self.method)
            object.__setattr__(self, "_gkey", g)
            return g

    def label(self) -> str:
        return f"{self.table}({','.join(self.cols)})^{self.method}"


@dataclasses.dataclass(frozen=True)
class Deduction:
    kind: str                       # "colset" | "colext"
    children: Tuple[NodeKey, ...]
    parts: Tuple[Tuple[str, ...], ...]  # column partition (colext)


@dataclasses.dataclass
class Node:
    key: NodeKey
    state: State = State.NONE
    chosen: Optional[Deduction] = None
    rv: err.ErrorRV = err.EXACT
    exact_bytes: Optional[float] = None


@dataclasses.dataclass
class Plan:
    f: float
    nodes: Dict[NodeKey, Node]
    targets: Tuple[NodeKey, ...]
    total_cost: float
    feasible: bool

    def states(self) -> Dict[NodeKey, State]:
        return {k: n.state for k, n in self.nodes.items()}

    def n_sampled(self) -> int:
        return sum(1 for n in self.nodes.values() if n.state is State.SAMPLED)

    def n_deduced(self) -> int:
        return sum(1 for n in self.nodes.values() if n.state is State.DEDUCED)


def sampling_cost(table: Table, key: NodeKey, f: float) -> float:
    """Cost of SampleCF = pages of the index built on the sample (§5.1)."""
    widths = [table.col_by_name[c].width for c in key.cols]
    n = max(2, int(round(table.nrows * f)))
    return float(uncompressed_pages(n, widths))


def memoized_sampling_cost(tables: Dict[str, Table], memo: Dict,
                           key: NodeKey, f: float) -> float:
    """`sampling_cost` behind a caller-owned (table, cols, f) memo."""
    ck = (key.table, key.cols, f)
    c = memo.get(ck)
    if c is None:
        c = memo[ck] = sampling_cost(tables[key.table], key, f)
    return c


@functools.lru_cache(maxsize=65536)
def _colext_deductions(key: NodeKey) -> Tuple[Deduction, ...]:
    """ColExt partitions of `key` (pure in the key, so cached globally)."""
    cols = key.cols
    if len(cols) < 2:
        return ()
    partitions = {tuple((c,) for c in cols)}
    partitions.add((cols[:-1], (cols[-1],)))
    partitions.add(((cols[0],), cols[1:]))
    return tuple(
        Deduction("colext",
                  tuple(NodeKey(key.table, p, key.method) for p in parts),
                  parts)
        for parts in sorted(partitions))


@functools.lru_cache(maxsize=262144)
def _colset_ded(other: NodeKey) -> Deduction:
    """One shared ColSet Deduction per mate (planner-engine graph build):
    a ColSet group of g nodes yields O(g^2) (target, mate) pairs but only
    g distinct deductions."""
    return Deduction("colset", (other,), (other.cols,))


def _colset_deductions(key: NodeKey, mates: Sequence[NodeKey]
                       ) -> List[Deduction]:
    """ColSet deductions from `mates` (same table/column-set/method nodes)."""
    if METHODS[key.method].order_dependent:
        return []
    return [Deduction("colset", (other,), (other.cols,))
            for other in mates if other.cols != key.cols]


def candidate_deductions(key: NodeKey, present: Sequence[NodeKey]
                         ) -> List[Deduction]:
    """Enumerate deductions for `key` (bounded, per §5.2 Figure 3).

    * ColSet: any present node with the same column SET + method (ORD-IND).
    * ColExt partitions: all singletons; (prefix, last); (first, rest).

    The scanning form over a plain node list, for `optimal` (the engine
    indexes its node set by ColSet group instead).
    """
    cs = frozenset(key.cols)
    mates = [o for o in present
             if o.table == key.table and o.method == key.method
             and frozenset(o.cols) == cs]
    return _colset_deductions(key, mates) + list(_colext_deductions(key))


@functools.lru_cache(maxsize=65536)
def _compose_cached(rvs: Tuple[err.ErrorRV, ...]) -> err.ErrorRV:
    # samplecf_error/colext_error are memoized, so the same ErrorRV objects
    # recur across targets and f values; cache their Goodman composition.
    return err.compose(rvs)


def _deduction_rv(key: NodeKey, d: Deduction,
                  nodes: Dict[NodeKey, Node]) -> err.ErrorRV:
    child_rvs = tuple(nodes[c].rv for c in d.children)
    if d.kind == "colset":
        drv = err.colset_error()
    else:
        drv = err.colext_error(key.method, len(d.children))
    return _compose_cached(child_rvs + (drv,))


class EstimationPlanner:
    """Runs the greedy state assignment through the batched
    `planner_engine.PlannerEngine`.  `existing` maps the NodeKeys of
    indexes that already exist to their true bytes (§5.1, e.g. from
    `samplecf.exact_size`): they enter every plan EXACT, at no sampling
    cost and no error.  `device` selects the engine's scoring backend:
    None scores in float64 NumPy (bit-identical to the JAX package's
    numpy backend), a torch device with the float32 planner-score
    kernels.  `use_engine=False` plans with the scalar reference
    `greedy_scalar` on the host instead, whatever the device.  `record`,
    `max_nodes`, `max_replay` and `faults` go to the engine: an online
    session's planner replays decisions across rounds within those
    bounds (see `planner_engine`)."""

    def __init__(self, tables: Dict[str, Table],
                 existing: Optional[Dict[NodeKey, float]] = None,
                 device=None, use_engine: bool = True, record: bool = False,
                 max_nodes: Optional[int] = None,
                 max_replay: Optional[int] = None, faults=None):
        self.tables = tables
        self.existing = dict(existing or {})
        self.device = device
        self.use_engine = use_engine
        self.record = record
        self.max_nodes = max_nodes
        self.max_replay = max_replay
        self.faults = faults
        self._engine = None
        self._scost: Dict[Tuple[str, Tuple[str, ...], float], float] = {}

    @property
    def engine(self):
        """The batched planner engine (built lazily, shared graph cache)."""
        if self._engine is None:
            from .planner_engine import PlannerEngine
            self._engine = PlannerEngine(
                self.tables, self.existing, device=self.device,
                record=self.record,
                max_nodes=self.max_nodes, max_replay=self.max_replay,
                faults=self.faults)
        return self._engine

    def _sampling_cost(self, key: NodeKey, f: float) -> float:
        return memoized_sampling_cost(self.tables, self._scost, key, f)

    def greedy(self, targets: Sequence[NodeKey], f: float, e: float,
               q: float) -> Plan:
        """One greedy run at fraction `f` (§5.2): the engine's pass with
        the single fraction (one `planner_walk` launch on a device), or
        `greedy_scalar` without the engine."""
        if not self.use_engine:
            return self.greedy_scalar(targets, f, e, q)
        return self.engine.greedy_batch(targets, e, q, (f,))[0]

    def greedy_scalar(self, targets: Sequence[NodeKey], f: float, e: float,
                      q: float) -> Plan:
        """The scalar §5.2 reference: per-(target, candidate) Python
        scoring in float64 on the host.  The engine's numpy backend is
        plan-identical to it (states, chosen deductions, total_cost) at
        every f; its torch backend agrees up to equal-p ties."""
        nodes: Dict[NodeKey, Node] = {}
        # (table, column set, method) -> nodes, in insertion order: the
        # ColSet mate lookup without scanning the whole node dict
        by_set: Dict[Tuple[str, frozenset, str], List[NodeKey]] = {}

        def index_key(k: NodeKey) -> None:
            by_set.setdefault((k.table, frozenset(k.cols), k.method),
                              []).append(k)

        # line 1: existing indexes enter known (EXACT: zero error, no cost)
        for k, size in self.existing.items():
            nodes[k] = Node(k, State.EXACT, rv=err.EXACT, exact_bytes=size)
            index_key(k)
        # line 2: targets start as NONE
        for t in targets:
            if t not in nodes:
                nodes[t] = Node(t)
                index_key(t)

        def ensure(k: NodeKey) -> Node:
            n = nodes.get(k)
            if n is None:
                n = nodes[k] = Node(k)
                index_key(k)
            return n

        def known(n: Node) -> bool:
            return n.state in (State.SAMPLED, State.DEDUCED, State.EXACT)

        total_cost = 0.0
        feasible = True
        used_as_child: set = set()
        # line 3: narrower to wider
        order = sorted(targets, key=lambda k: (len(k.cols), k.cols))
        for t in order:
            node = nodes[t]
            if known(node):
                continue
            # lines 4-5: materialize candidate deductions and children
            mates = by_set.get((t.table, frozenset(t.cols), t.method), ())
            cands = _colset_deductions(t, mates) + list(_colext_deductions(t))
            for d in cands:
                for c in d.children:
                    ensure(c)

            # lines 6-7: an already-enabled deduction that satisfies e, q
            best_d, best_p = None, -1.0
            for d in cands:
                if all(known(nodes[c]) for c in d.children):
                    rv = _deduction_rv(t, d, nodes)
                    p = err.prob_within(rv, e)
                    if p >= q and p > best_p:
                        best_d, best_p = d, p
            if best_d is not None:
                node.state = State.DEDUCED
                node.chosen = best_d
                node.rv = _deduction_rv(t, best_d, nodes)
                used_as_child.update(best_d.children)
                continue

            # lines 8-9: enable a deduction by sampling its unknown
            # children where that is cheaper than sampling this node
            my_cost = self._sampling_cost(t, f)
            best_d, best_cost = None, my_cost
            for d in cands:
                unknown = [c for c in d.children if not known(nodes[c])]
                if not unknown:
                    continue  # handled above (did not satisfy constraint)
                extra = sum(self._sampling_cost(c, f) for c in unknown)
                if extra >= best_cost:
                    continue
                # hypothetical RVs with the unknown children sampled
                trial = {c: err.samplecf_error(c.method, f) for c in unknown}
                child_rvs = tuple(trial.get(c, nodes[c].rv)
                                  for c in d.children)
                drv = (err.colset_error() if d.kind == "colset"
                       else err.colext_error(t.method, len(d.children)))
                rv = _compose_cached(child_rvs + (drv,))
                if err.prob_within(rv, e) >= q:
                    best_d, best_cost = d, extra
            if best_d is not None:
                for c in best_d.children:
                    cn = nodes[c]
                    if not known(cn):
                        cn.state = State.SAMPLED
                        cn.rv = err.samplecf_error(c.method, f)
                        total_cost += self._sampling_cost(c, f)
                node.state = State.DEDUCED
                node.chosen = best_d
                node.rv = _deduction_rv(t, best_d, nodes)
                used_as_child.update(best_d.children)
                continue

            # lines 10-11: fall back to SampleCF on this node
            node.state = State.SAMPLED
            node.rv = err.samplecf_error(t.method, f)
            total_cost += my_cost
            if not err.satisfies(node.rv, e, q):
                feasible = False  # even sampling cannot satisfy the bound

        # lines 13-14: cleanup, dropping nodes neither targeted nor used
        tset = set(targets)
        for k in sorted(list(nodes), key=lambda k: -len(k.cols)):
            n = nodes[k]
            if k in tset or k in used_as_child or n.state is State.EXACT:
                continue
            if n.state is State.SAMPLED:
                total_cost -= self._sampling_cost(k, f)
            del nodes[k]

        for t in targets:
            if not err.satisfies(nodes[t].rv, e, q):
                feasible = False
        return Plan(f=f, nodes=nodes, targets=tuple(targets),
                    total_cost=total_cost, feasible=feasible)

    def plan(self, targets: Sequence[NodeKey], e: float, q: float) -> Plan:
        """Outer loop over the sampling fractions of F_GRID (§5.2 last
        paragraph): one batched pass over the shared graph scores every
        fraction and only the winning plan is materialized; without the
        engine, `greedy_scalar` at each fraction, the cheapest feasible
        plan (else the cheapest)."""
        if self.use_engine:
            return self.engine.plan_batch(targets, e, q)
        best: Optional[Plan] = None
        fallback: Optional[Plan] = None
        for f in F_GRID:
            p = self.greedy_scalar(targets, f, e, q)
            if p.feasible and (best is None or p.total_cost < best.total_cost):
                best = p
            if fallback is None or p.total_cost < fallback.total_cost:
                fallback = p
        return best if best is not None else fallback

    def plan_scalar(self, targets: Sequence[NodeKey], e: float,
                    q: float) -> Plan:
        """`plan` on the scalar reference greedy, whatever `use_engine`."""
        saved = self.use_engine
        try:
            self.use_engine = False
            return self.plan(targets, e, q)
        finally:
            self.use_engine = saved

    def plan_all_sampled(self, targets: Sequence[NodeKey], e: float,
                         q: float) -> Plan:
        """The paper's "All" baseline: SampleCF on every target, no
        deductions; the first grid fraction whose all-sampled plan meets
        (e, q), else the cheapest all-sampled plan, flagged infeasible.
        (Sampling is forced by a greedy under FORCE_ALL_Q, feasibility
        then judged against the caller's q.)"""
        if self.use_engine:
            return self.engine.plan_all_sampled_batch(targets, e, q)
        fallback: Optional[Plan] = None
        for f in F_GRID:
            p = self.greedy_scalar(targets, f, e, FORCE_ALL_Q)
            feasible = all(err.satisfies(p.nodes[t].rv, e, q)
                           for t in targets)
            p = dataclasses.replace(p, feasible=feasible)
            if feasible:
                return p
            if fallback is None or p.total_cost < fallback.total_cost:
                fallback = p
        return fallback

    # ------------------------------------------------------------------
    # Optimal exact algorithm (Appendix D) — exponential; experiments only.
    # ------------------------------------------------------------------
    def optimal(self, targets: Sequence[NodeKey], f: float, e: float,
                q: float, max_nodes: int = 14) -> Plan:
        targets = list(targets)
        if len(targets) > max_nodes:
            raise ValueError("optimal(): too many targets (exponential)")
        base_nodes: Dict[NodeKey, Node] = {
            k: Node(k, State.EXACT, rv=err.EXACT, exact_bytes=size)
            for k, size in self.existing.items()}

        # Universe: targets + all their (recursive) potential children.
        universe: Dict[NodeKey, List[Deduction]] = {}
        frontier = list(targets)
        while frontier:
            k = frontier.pop()
            if k in universe:
                continue
            cands = candidate_deductions(
                k, list(universe) + list(base_nodes) + list(targets))
            universe[k] = cands
            for d in cands:
                for c in d.children:
                    if c not in universe:
                        frontier.append(c)

        best: List[Optional[Plan]] = [None]

        def recurse(states: Dict[NodeKey, Tuple[State, Optional[Deduction]]],
                    remaining: List[NodeKey], cost: float) -> None:
            if best[0] is not None and cost >= best[0].total_cost:
                return  # prune
            if not remaining:
                nodes = dict(base_nodes)
                # resolve rvs narrow->wide
                for k in sorted(states, key=lambda k: (len(k.cols), k.cols)):
                    st, d = states[k]
                    n = Node(k, st)
                    if st is State.SAMPLED:
                        n.rv = err.samplecf_error(k.method, f)
                    else:
                        if any(c not in nodes and c not in states
                               for c in d.children):
                            return
                        n.chosen = d
                        n.rv = _deduction_rv(k, d, nodes)
                    nodes[k] = n
                for t in targets:
                    if not err.satisfies(nodes[t].rv, e, q):
                        return
                best[0] = Plan(f=f, nodes=nodes, targets=tuple(targets),
                               total_cost=cost, feasible=True)
                return
            # branch on the widest remaining index (App. D line 7)
            remaining = sorted(remaining, key=lambda k: (len(k.cols), k.cols))
            k = remaining[-1]
            rest = remaining[:-1]
            # option 1: SAMPLED, priced by the §5.1 formula the engine uses
            recurse({**states, k: (State.SAMPLED, None)}, rest,
                    cost + self._sampling_cost(k, f))
            # option 2: each deduction; children must be decided too
            for d in universe.get(k, []):
                new_children = [c for c in d.children
                                if c not in states and c not in base_nodes
                                and c not in rest and c != k]
                recurse({**states, k: (State.DEDUCED, d)},
                        rest + new_children, cost)

        recurse({}, list(targets), 0.0)
        if best[0] is None:
            return self.greedy(targets, f, e, q)
        return best[0]

    def execute(self, plan: Plan, engine: EstimationEngine
                ) -> Dict[NodeKey, SizeEstimate]:
        """Execute `plan`: all SAMPLED nodes are estimated in grouped
        kernel calls (one batch per (table, f) group), then deductions
        resolve from those."""
        sampled = [k for k, n in plan.nodes.items()
                   if n.state is State.SAMPLED]
        pre = engine.estimate_batch(sampled, plan.f)
        return self._resolve_plan(plan, pre.__getitem__)

    def execute_scalar(self, plan: Plan, manager: SampleManager
                       ) -> Dict[NodeKey, SizeEstimate]:
        """The reference executor: one `sample_cf` call per SAMPLED node,
        in NumPy on the host; `execute` is byte-identical to it."""
        return self._resolve_plan(
            plan, lambda k: sample_cf(
                manager, IndexDef(k.table, k.cols, k.method), plan.f))

    def execute_cached(self, plan: Plan,
                       cache: MutableMapping[Tuple[NodeKey, float],
                                             SizeEstimate],
                       engine: EstimationEngine, scalar: bool = False
                       ) -> Dict[NodeKey, SizeEstimate]:
        """`execute` with SAMPLED estimates cached by (NodeKey, f), the
        online session's path: an estimate is a pure function of (node,
        f) over the engine's order-independent samples, so only the cache
        misses are estimated, in one batched call (with `scalar`, one
        `sample_cf` each over the engine's `SampleManager`, on the host).
        The plan resolves from a LOCAL snapshot of this call's estimates,
        never back through `cache`: a bounded cache
        (`samplecf.EstimateCache`) may evict an entry this plan still
        needs while inserting."""
        local: Dict[NodeKey, SizeEstimate] = {}
        missing = []
        for k, n in plan.nodes.items():
            if n.state is not State.SAMPLED:
                continue
            est = cache.get((k, plan.f))
            if est is None:
                missing.append(k)
            else:
                local[k] = est
        if missing and scalar:
            for k in missing:
                local[k] = cache[(k, plan.f)] = sample_cf(
                    engine.manager, IndexDef(k.table, k.cols, k.method),
                    plan.f)
        elif missing:
            for k, est in engine.estimate_batch(missing, plan.f).items():
                local[k] = cache[(k, plan.f)] = est
        return self._resolve_plan(plan, local.__getitem__)

    def _resolve_plan(self, plan: Plan, sampled_est
                      ) -> Dict[NodeKey, SizeEstimate]:
        out: Dict[NodeKey, SizeEstimate] = {}

        def resolve(k: NodeKey) -> SizeEstimate:
            if k in out:
                return out[k]
            node = plan.nodes[k]
            table = self.tables[k.table]
            if node.state is State.EXACT:
                est = SizeEstimate(
                    index=IndexDef(k.table, k.cols, k.method),
                    est_bytes=float(node.exact_bytes), method="exact",
                    cost_pages=0.0, cf=0.0)
            elif node.state is State.SAMPLED:
                est = sampled_est(k)
            else:  # DEDUCED
                d = node.chosen
                assert d is not None
                if d.kind == "colset":
                    size = ded.colset_deduce(resolve(d.children[0]).est_bytes)
                else:
                    parts = [(c.cols, resolve(c).est_bytes)
                             for c in d.children]
                    size = ded.deduce(table, k.method, k.cols, parts)
                est = SizeEstimate(
                    index=IndexDef(k.table, k.cols, k.method),
                    est_bytes=size, method=f"deduction:{d.kind}",
                    cost_pages=0.0,
                    cf=size / max(ded.uncompressed_size(table, k.cols), 1.0))
            out[k] = est
            return est

        for t in plan.targets:
            resolve(t)
        # also resolve intermediate sampled nodes (useful to callers)
        for k, n in plan.nodes.items():
            if n.state is not State.NONE:
                resolve(k)
        return out
