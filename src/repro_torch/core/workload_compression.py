"""Workload compression: advise on weighted representatives (paper §7,
"large workloads").

Every structure in the advisor pipeline is linear in the statement count, and
the `CostEngine` matrices are `(statements x candidates)` dense — at the
paper's §7 "large workload" regime (tens of thousands of statements, DTA-style
traces) both wall time and memory grow without bound.  This module clusters
statements by *signature* and hands the pipeline a budget-bounded compressed
workload of weighted representatives, together with a per-cluster cost-error
bound so a recommendation on the compressed workload carries a certificate of
how far its cost can be from the full-workload cost.

Two cluster tiers, chosen per statement budget:

* **Fine (certified) clusters** — signature = (statement kind, table,
  sorted (filter column, selectivity bucket) pairs, projected-column set)
  for queries and (kind, table, log2 row-count bucket) for bulk inserts.
  Within a fine cluster every member shares the *structure* the cost model
  sees (table, filter-column set, covering set, ncols) and differs only in
  per-column selectivity (queries) or rows written (inserts).  The cost
  model is monotone in both (`seek_cost`/`rid_lookup_cost` nondecreasing in
  selectivity, `update_cost` nondecreasing in rows), and the selectivity
  buckets pin each column to one side of the covering `sel >= 1` branch, so
  for ANY predicate-free configuration each member's cost is sandwiched
  between the costs of two *bounding statements* built from the member
  extremes.  The reported per-cluster error term
  ``W * (max(c_hi, c_rep) - min(c_lo, c_rep))`` is therefore a theorem of
  the cost model, not a heuristic.
* **Coarse (envelope) clusters** — the budget tail.  Statements whose fine
  cluster did not earn a representative slot fall back to ONE envelope
  cluster per (statement kind, table), so the representative count is
  genuinely bounded by the budget (down to the ~2x#tables structural
  floor).  A coarse query cluster's error term uses the universal envelope
  ``0 <= cost(q, cfg) <= scan(clustered layout)`` (a query's cost is a min
  over paths that always includes the clustered scan) — sound for any
  configuration, looser than the certificate; `scan_cost` is linear in
  `ncols_used`, so the per-cluster envelope aggregates in O(1) per
  configuration.  Coarse insert clusters keep the monotone certificate
  (it never needed structural sharing).

Budget allocation is a pure function of the cluster statistics: fine
clusters are ranked by total weight (ties by signature) and the heaviest
keep representative slots, the rest spill into the coarse tier; a fixpoint
loop balances slots between the tiers.  Representative *content* is a pure
function of the cluster signature and table statistics (canonical
predicates at the bucket midpoint, content-addressed names), so membership
churn only changes representative *weights*.  All weight sums run in
member-name-sorted order, so the compressed workload does not depend on
statement order.  Everything here is float64 host code, equal to the JAX
package's module.

With the budget disabled (`None`, or >= the statement count)
`compress_workload` returns None and the advisor runs the uncompressed
pipeline unchanged.

`ClusterIndex.apply_delta` mirrors an online session's `WorkloadDelta`,
so the outer compressed `AdvisorSession` keeps cluster membership in
O(delta) and derives the compressed workload a fresh `compress_workload`
would.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Tuple

from . import cost_model as cm
from .relation import Predicate, Table
from .whatif import (Configuration, SizeProvider, query_cost,
                     update_statement_cost)
from .workload import BulkInsert, Query, Statement, Workload

# selectivity bucket b covers (2^-(b+1), 2^-b]; MAX_BUCKET absorbs the tail
MAX_BUCKET = 24
# canonical representative selectivity inside bucket b: 0.75 * 2^-b
_BUCKET_MID = 0.75


def _sel_bucket(sel: float) -> str:
    """Selectivity bucket key.  "E" (exactly-one) is its own bucket: the
    covering-path formula switches from seek to scan at sel == 1, and the
    certificate needs every member of a cluster on the same side."""
    if sel >= 1.0:
        return "E"
    if sel <= 2.0 ** -MAX_BUCKET:
        return f"{MAX_BUCKET:02d}"
    return f"{min(MAX_BUCKET, int(math.floor(-math.log2(sel)))):02d}"


@dataclasses.dataclass
class _Member:
    """Per-statement facts the bound and the weights need."""
    weight: float
    # queries: {col: (selectivity, predicate)} over the canonical filter
    # dict (last predicate per column wins — the cost model's semantics)
    sels: Optional[Dict[str, Tuple[float, Predicate]]] = None
    ncols: int = 0
    # inserts
    nrows: int = 0


def _canonical_filters(q: Query, table: Table) -> Dict[str,
                                                       Tuple[float, Predicate]]:
    out: Dict[str, Tuple[float, Predicate]] = {}
    for p in q.filters:
        out[p.col] = (p.selectivity(table), p)
    return out


def _statement_facts(s: Statement,
                     table: Table) -> Tuple[Tuple, Tuple, _Member]:
    """(fine sig, coarse sig, member facts) in one pass — the canonical
    filter dict and the column set feed both the signature and the member,
    and computing them once halves per-statement clustering cost."""
    if isinstance(s, Query):
        filt = _canonical_filters(s, table)
        fsig = tuple(sorted((c, _sel_bucket(sel))
                            for c, (sel, _) in filt.items()))
        cols = set(s.all_cols())
        fine = ("q", s.table, fsig, tuple(sorted(cols)))
        member = _Member(weight=float(s.weight), sels=filt,
                         ncols=len(cols))
        return fine, ("q~", s.table), member
    fine = ("u", s.table, f"{max(0, int(s.nrows).bit_length() - 1):02d}")
    member = _Member(weight=float(s.weight), nrows=int(s.nrows))
    return fine, ("u~", s.table), member


def statement_signatures(s: Statement, table: Table) -> Tuple[Tuple, Tuple]:
    """(fine, coarse) cluster signatures of one statement — pure in the
    statement and the table's min/max statistics, so clustering is
    deterministic and independent of statement order."""
    fine, coarse, _ = _statement_facts(s, table)
    return fine, coarse


def _rep_name(key: Tuple) -> str:
    return "wc" + hashlib.sha1(repr(key).encode()).hexdigest()[:12]


def _canonical_pred(table: Table, col: str, bucket: str) -> Predicate:
    mn, mx = table.minmax(col)
    if bucket == "E":
        return Predicate(col, mn, mx)
    domain = mx - mn + 1
    target = _BUCKET_MID * 2.0 ** (-int(bucket))
    width = max(1, int(round(target * domain)))
    return Predicate(col, mn, mn + width - 1)


@dataclasses.dataclass
class Cluster:
    """One representative's cluster: identity, members, and bound data."""
    tier: str                      # "fine" | "coarse"
    sig: Tuple
    rep: Statement                 # weight = total member weight
    members: Dict[str, _Member]    # statement name -> facts
    weight: float

    @property
    def certified(self) -> bool:
        """True when the error term is the monotone-sandwich certificate
        (fine clusters and all insert clusters); False for the coarse
        query tier's scan envelope."""
        return self.tier == "fine" or self.sig[0] == "u~"

    # -- error term ------------------------------------------------------
    def _bounding_queries(self, table: Table) -> Tuple[Query, Query]:
        """Member-extreme bounding queries: per filter column take the
        member predicate with min (resp. max) selectivity.  Componentwise
        monotonicity of `query_cost` makes cost(lo) <= cost(member) <=
        cost(hi) for every member under any predicate-free config."""
        assert self.tier == "fine" and self.sig[0] == "q"
        proj = self.sig[3]
        lo_p, hi_p = [], []
        for col, _bucket in self.sig[2]:
            pairs = [m.sels[col] for m in self.members.values()]
            lo_p.append(min(pairs, key=lambda t: (t[0], t[1].lo, t[1].hi))[1])
            hi_p.append(max(pairs, key=lambda t: (t[0], t[1].lo, t[1].hi))[1])
        mk = lambda tag, preds: Query(f"{self.rep.name}:{tag}",
                                      self.rep.table, tuple(preds), proj,
                                      weight=self.weight)
        return mk("lo", lo_p), mk("hi", hi_p)

    def error_term(self, config: Configuration, sizes: SizeProvider,
                   table: Table) -> float:
        """Sound upper bound on |sum_s w_s cost(s, cfg) - W * cost(rep,
        cfg)| for this cluster under `config` (predicate-free indexes)."""
        W = self.weight
        if isinstance(self.rep, BulkInsert):
            rows = [m.nrows for m in self.members.values()]
            c_lo = update_statement_cost(
                dataclasses.replace(self.rep, nrows=min(rows)), config, sizes)
            c_hi = update_statement_cost(
                dataclasses.replace(self.rep, nrows=max(rows)), config, sizes)
            c_rep = update_statement_cost(self.rep, config, sizes)
            return W * (max(c_hi, c_rep) - min(c_lo, c_rep))
        if self.tier == "fine":
            q_lo, q_hi = self._bounding_queries(table)
            c_lo = query_cost(q_lo, config, sizes)
            c_hi = query_cost(q_hi, config, sizes)
            c_rep = query_cost(self.rep, config, sizes)
            return W * (max(c_hi, c_rep) - min(c_lo, c_rep))
        # coarse query envelope: 0 <= cost(s) <= scan(clustered layout),
        # and scan_cost is linear in ncols_used, so the weighted member
        # envelope collapses to one scan_cost call at the weighted mean
        clustered = config.clustered(self.rep.table)
        assert clustered is not None
        w_ncols = sum(m.weight * m.ncols
                      for _, m in sorted(self.members.items()))
        env = W * cm.scan_cost(sizes.size(clustered), table.nrows,
                               w_ncols / W, clustered.compression)
        c_rep = W * query_cost(self.rep, config, sizes)
        return max(c_rep, env - c_rep)


@dataclasses.dataclass
class CompressedWorkload:
    """A budget-bounded weighted-representative workload + its certificate."""
    workload: Workload             # representative statements, sig-sorted
    clusters: List[Cluster]        # aligned with workload.statements
    n_full: int
    budget: int

    @property
    def n_representatives(self) -> int:
        return len(self.clusters)

    @property
    def compression_ratio(self) -> float:
        return self.n_full / max(1, len(self.clusters))

    def cluster_of(self) -> Dict[str, str]:
        """statement name -> representative name (membership map)."""
        out: Dict[str, str] = {}
        for c in self.clusters:
            for name in c.members:
                out[name] = c.rep.name
        return out

    def error_bound(self, config: Configuration,
                    sizes: SizeProvider) -> float:
        """Sound bound on |C_full(config) - C_compressed(config)| in cost
        units, summed over per-cluster terms (see `Cluster.error_term`).
        Valid for any configuration of predicate-free indexes — the only
        kind the advisor pipeline generates."""
        tables = sizes.schema.tables
        return sum(c.error_term(config, sizes, tables[c.rep.table])
                   for c in self.clusters)


class ClusterIndex:
    """Incremental cluster membership over a (possibly huge) workload.

    `add`/`remove`/`reweight` are O(1) per statement; `derive(budget)`
    recomputes the budgeted representative set as a pure function of the
    current membership statistics, so an index maintained by them and a
    fresh `ClusterIndex.from_workload` on the resulting workload derive
    identical compressed workloads.
    """

    def __init__(self, schema):
        self.schema = schema
        # fine sig -> {name: _Member}; per-name reverse map for removal
        self._fine: Dict[Tuple, Dict[str, _Member]] = {}
        self._by_name: Dict[str, Tuple[Tuple, Tuple]] = {}

    @classmethod
    def from_workload(cls, workload: Workload) -> "ClusterIndex":
        ix = cls(workload.schema)
        for s in workload.statements:
            ix.add(s)
        return ix

    def __len__(self) -> int:
        return len(self._by_name)

    # -- membership maintenance (O(delta)) ------------------------------
    def add(self, s: Statement) -> None:
        table = self.schema.tables[s.table]
        fine, coarse, member = _statement_facts(s, table)
        if s.name in self._by_name:
            raise ValueError(f"duplicate statement name {s.name!r}")
        self._by_name[s.name] = (fine, coarse)
        self._fine.setdefault(fine, {})[s.name] = member

    def remove(self, name: str) -> None:
        fine, _ = self._by_name.pop(name)
        members = self._fine[fine]
        del members[name]
        if not members:
            del self._fine[fine]

    def reweight(self, name: str, weight: float) -> None:
        fine, _ = self._by_name[name]
        self._fine[fine][name].weight = float(weight)

    def apply_delta(self, delta) -> None:
        """Mirror a validated `workload.WorkloadDelta`."""
        for name in delta.removed:
            self.remove(name)
        for name, w in delta.reweighted:
            self.reweight(name, w)
        for s in delta.added:
            self.add(s)

    # -- derivation ------------------------------------------------------
    def _fine_weight(self, members: Dict[str, _Member]) -> float:
        # name-sorted summation: bit-identical between an incrementally
        # maintained index and a fresh one on the same workload
        return sum(members[n].weight for n in sorted(members))

    def _rep(self, tier: str, sig: Tuple, weight: float) -> Statement:
        name = _rep_name((tier, sig))
        if sig[0] == "q":
            table = self.schema.tables[sig[1]]
            preds = tuple(_canonical_pred(table, c, b) for c, b in sig[2])
            return Query(name, sig[1], preds, sig[3], weight=weight)
        if sig[0] == "q~":
            table = self.schema.tables[sig[1]]
            cols = tuple(c.name for c in table.columns)
            return Query(name, sig[1], (), cols, weight=weight)
        if sig[0] == "u":
            b = int(sig[2])
            return BulkInsert(name, sig[1], max(1, int(1.5 * 2 ** b)),
                              weight=weight)
        assert sig[0] == "u~"
        table = self.schema.tables[sig[1]]
        return BulkInsert(name, sig[1], max(table.nrows // 50, 1),
                          weight=weight)

    def derive(self, budget: Optional[int]) -> Optional[CompressedWorkload]:
        """The budgeted compressed workload of the current membership, or
        None when the budget is disabled or >= the statement count (the
        exact-parity bypass)."""
        n_full = len(self._by_name)
        if budget is None or n_full <= budget:
            return None
        fine_stats = [(self._fine_weight(m), sig, m)
                      for sig, m in self._fine.items()]
        order = sorted(fine_stats, key=lambda t: (-t[0], repr(t[1])))
        # fixpoint: fine representative slots vs coarse tail clusters.
        # Shrinking the kept set only grows the tail, so k is monotone
        # nonincreasing and the loop terminates.
        k = min(len(order), budget)
        while True:
            coarse_sigs = {self._by_name[name][1]
                           for _, _, members in order[k:]
                           for name in members}
            k_new = min(len(order), max(0, budget - len(coarse_sigs)))
            if k_new >= k:
                break
            k = k_new
        clusters: List[Cluster] = []
        for w, sig, members in order[:k]:
            clusters.append(Cluster("fine", sig,
                                    self._rep("fine", sig, w),
                                    dict(members), w))
        coarse: Dict[Tuple, Dict[str, _Member]] = {}
        for _, _sig, members in order[k:]:
            for name, m in members.items():
                coarse.setdefault(self._by_name[name][1], {})[name] = m
        for csig, members in coarse.items():
            w = self._fine_weight(members)
            clusters.append(Cluster("coarse", csig,
                                    self._rep("coarse", csig, w),
                                    members, w))
        clusters.sort(key=lambda c: (c.tier, repr(c.sig)))
        wl = Workload(schema=self.schema,
                      statements=[c.rep for c in clusters])
        return CompressedWorkload(workload=wl, clusters=clusters,
                                  n_full=n_full, budget=budget)


def compress_workload(workload: Workload,
                      budget: Optional[int]) -> Optional[CompressedWorkload]:
    """Cluster `workload` into <= `budget` weighted representatives (None
    disables; budget >= statement count returns None — the exact-parity
    bypass the advisor relies on).  The spilled tail can push the
    representative count above `budget` only when the budget is below the
    number of distinct coarse signatures (the structural floor)."""
    if budget is None or len(workload.statements) <= budget:
        return None
    return ClusterIndex.from_workload(workload).derive(budget)
