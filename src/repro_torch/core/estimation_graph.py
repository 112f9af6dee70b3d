"""Estimation-plan optimization over the index/deduction graph (paper §5).

Given target compressed indexes, a tolerable error e and confidence q, choose
for each index either SampleCF (costly, accurate) or a deduction (free, less
accurate) plus a single sampling fraction f, minimizing total estimation cost
subject to: P(|relative error| within e) >= q for every target.

The paper's greedy algorithm (§5.2 pseudocode) runs on the batched
`planner_engine.PlannerEngine`, which scores every sampling fraction in one
pass over a shared deduction graph; plans are then executed with the
batched SampleCF `EstimationEngine`.  The JAX package's frozen scalar
greedy and the exponential Optimal recursion (Appendix D) are not ported.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Dict, Optional, Sequence, Tuple

from . import deduction as ded
from . import errors as err
from .estimation_engine import EstimationEngine
from .relation import IndexDef, Table, uncompressed_pages
from .samplecf import SizeEstimate

F_GRID = (0.01, 0.025, 0.05, 0.075, 0.10)

# q strictly above any probability: every deduction fails the constraint, so
# greedy degenerates to SampleCF-on-everything (the paper's "All" baseline).
FORCE_ALL_Q = 1.1


class State(enum.Enum):
    NONE = "NONE"
    DEDUCED = "DEDUCED"
    SAMPLED = "SAMPLED"
    EXACT = "EXACT"  # known exactly (§5.1); marks the planner's pad node


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


@dataclasses.dataclass
class Plan:
    f: float
    nodes: Dict[NodeKey, Node]
    targets: Tuple[NodeKey, ...]
    total_cost: float
    feasible: bool

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


class EstimationPlanner:
    """Runs the greedy state assignment through the batched
    `planner_engine.PlannerEngine`.  `device` selects the engine's scoring
    backend: None scores in float64 NumPy (bit-identical to the JAX
    package's numpy backend), a torch device with the float32
    planner-score kernels."""

    def __init__(self, tables: Dict[str, Table], device=None):
        self.tables = tables
        self.device = device
        self._engine = None

    @property
    def engine(self):
        """The batched planner engine (built lazily, shared graph cache)."""
        if self._engine is None:
            from .planner_engine import PlannerEngine
            self._engine = PlannerEngine(self.tables, device=self.device)
        return self._engine

    def plan(self, targets: Sequence[NodeKey], e: float, q: float) -> Plan:
        """Outer loop over the sampling fractions of F_GRID (§5.2 last
        paragraph): one batched pass over the shared graph scores every
        fraction; only the winning plan is materialized."""
        return self.engine.plan_batch(targets, e, q)

    def plan_all_sampled(self, targets: Sequence[NodeKey], e: float,
                         q: float) -> Plan:
        """The paper's "All" baseline: SampleCF on every target, no
        deductions; the first grid fraction whose all-sampled plan meets
        (e, q), else the cheapest all-sampled plan, flagged infeasible."""
        return self.engine.plan_all_sampled_batch(targets, e, q)

    def execute(self, plan: Plan, engine: EstimationEngine
                ) -> Dict[NodeKey, SizeEstimate]:
        """Execute `plan`: all SAMPLED nodes are estimated in grouped
        kernel calls (one batch per (table, f) group), then deductions
        resolve from those."""
        sampled = [k for k, n in plan.nodes.items()
                   if n.state is State.SAMPLED]
        pre = engine.estimate_batch(sampled, plan.f)
        return self._resolve_plan(plan, pre.__getitem__)

    def _resolve_plan(self, plan: Plan, sampled_est
                      ) -> Dict[NodeKey, SizeEstimate]:
        out: Dict[NodeKey, SizeEstimate] = {}

        def resolve(k: NodeKey) -> SizeEstimate:
            if k in out:
                return out[k]
            node = plan.nodes[k]
            table = self.tables[k.table]
            if node.state is State.SAMPLED:
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
