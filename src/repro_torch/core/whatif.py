"""What-if support: sizes, configurations and budget accounting (paper §1,
§3; the DTA architecture of Figure 1).

A Configuration is a set of IndexDef (one clustered layout per table plus
secondary indexes).  Sizes of compressed structures come from a SizeProvider
fed by the estimation framework (§4-§5); uncompressed sizes are analytic.
Statement costs under a configuration come from the batched
`cost_engine.CostEngine`.  The scalar float64 `query_cost` and
`update_statement_cost` price one statement at a time; the workload
compression certificate (`workload_compression`) uses them, and
`WhatIfOptimizer` (the Figure-1 optimizer extension) caches and sums them
per statement beside its batched `workload_cost_batch`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, Optional, Tuple

import numpy as np
import torch

from . import cost_model as cm
from .compression import uncompressed_payload_bytes
from .relation import IndexDef, Table
from .synopses import Schema
from .workload import BulkInsert, Query, Statement, Workload


class SizeProvider:
    """Maps IndexDef -> estimated physical bytes.

    Uncompressed indexes are sized analytically; compressed sizes must be
    registered (from the §5 estimation framework) or an analytic fallback
    CF prior is used (flagged, so the advisor always registers real ones).
    """

    DEFAULT_CF_PRIOR = 0.55

    def __init__(self, schema: Schema):
        self.schema = schema
        self._sizes: Dict[Tuple, float] = {}
        self.fallback_hits = 0

    @staticmethod
    def _key(idx: IndexDef) -> Tuple:
        return (idx.table, idx.cols, idx.compression, idx.predicate)

    def register(self, idx: IndexDef, est_bytes: float) -> None:
        self._sizes[self._key(idx)] = float(est_bytes)

    def analytic_uncompressed(self, idx: IndexDef) -> float:
        t = self.schema.tables[idx.table]
        widths = [t.col_by_name[c].width for c in idx.cols]
        nrows = t.nrows
        if idx.predicate is not None:
            nrows = int(round(nrows * idx.predicate.selectivity(t)))
        return float(uncompressed_payload_bytes(nrows, widths))

    def size(self, idx: IndexDef) -> float:
        if idx.compression is None:
            return self.analytic_uncompressed(idx)
        key = self._key(idx)
        if key in self._sizes:
            return self._sizes[key]
        self.fallback_hits += 1
        return self.analytic_uncompressed(idx) * self.DEFAULT_CF_PRIOR

    def nrows(self, idx: IndexDef) -> float:
        t = self.schema.tables[idx.table]
        if idx.predicate is not None:
            return t.nrows * idx.predicate.selectivity(t)
        return float(t.nrows)


@dataclasses.dataclass(frozen=True)
class Configuration:
    indexes: FrozenSet[IndexDef]

    @staticmethod
    def of(indexes: Iterable[IndexDef]) -> "Configuration":
        return Configuration(frozenset(indexes))

    def add(self, idx: IndexDef) -> "Configuration":
        return Configuration(self.indexes | {idx})

    def remove(self, idx: IndexDef) -> "Configuration":
        return Configuration(self.indexes - {idx})

    def replace(self, old: IndexDef, new: IndexDef) -> "Configuration":
        return Configuration((self.indexes - {old}) | {new})

    def for_table(self, table: str) -> Tuple[IndexDef, ...]:
        return tuple(sorted((i for i in self.indexes if i.table == table),
                            key=lambda i: i.label()))

    def clustered(self, table: str) -> Optional[IndexDef]:
        for i in self.indexes:
            if i.table == table and i.clustered:
                return i
        return None


def base_configuration(schema: Schema) -> Configuration:
    """Uncompressed clustered layout (heap) per table — the initial design."""
    idxs = []
    for t in schema.tables.values():
        cols = tuple(c.name for c in t.columns)
        idxs.append(IndexDef(t.name, cols, compression=None, clustered=True))
    return Configuration.of(idxs)


def storage_used(config: Configuration, base: Configuration,
                 sizes: SizeProvider) -> float:
    """Budget accounting: bytes beyond the uncompressed base layout.

    Compressing a clustered index *frees* budget (paper App. D.2: DTAc can
    produce indexes even at a 0% budget by compressing existing tables).
    """
    total = sum(sizes.size(i) for i in config.indexes)
    baseline = sum(sizes.size(i) for i in base.indexes)
    return total - baseline


# ---------------------------------------------------------------------------
# Scalar statement costs: access-path selection (System-R-lite) with
# compression-aware CPU, in float64 on the host
# ---------------------------------------------------------------------------

def _prefix_selectivity(idx: IndexDef, query: Query, table: Table) -> float:
    """Selectivity of filters matching the index's leading key prefix."""
    filt = {p.col: p for p in query.filters}
    sel = 1.0
    matched = False
    for c in idx.cols:
        if c in filt:
            sel *= filt[c].selectivity(table)
            matched = True
        else:
            break
    return sel if matched else 1.0


def _covers(idx: IndexDef, query: Query) -> bool:
    return set(query.all_cols()) <= set(idx.cols)


def _partial_applicable(idx: IndexDef, query: Query) -> bool:
    if idx.predicate is None:
        return True
    for p in query.filters:
        if (p.col == idx.predicate.col and p.lo >= idx.predicate.lo
                and p.hi <= idx.predicate.hi):
            return True
    return False


def query_cost(query: Query, config: Configuration,
               sizes: SizeProvider) -> float:
    table = sizes.schema.tables[query.table]
    ncols_used = len(query.all_cols())
    clustered = config.clustered(query.table)
    assert clustered is not None, f"no clustered layout for {query.table}"

    base_size = sizes.size(clustered)
    best = cm.scan_cost(base_size, table.nrows, ncols_used,
                        clustered.compression)

    for idx in config.for_table(query.table):
        if idx.clustered or not _partial_applicable(idx, query):
            continue
        nrows_idx = sizes.nrows(idx)
        isize = sizes.size(idx)
        sel = _prefix_selectivity(idx, query, table)
        covering = _covers(idx, query)
        if covering:
            if sel < 1.0:
                cost = cm.seek_cost(isize, nrows_idx, sel, ncols_used,
                                    idx.compression)
            else:
                cost = cm.scan_cost(isize, nrows_idx, ncols_used,
                                    idx.compression)
        else:
            if sel >= 1.0:
                continue  # non-covering full scan is never chosen
            cost = cm.seek_cost(isize, nrows_idx, sel, len(idx.cols),
                                idx.compression)
            cost += cm.rid_lookup_cost(
                nrows_idx * sel, base_size, ncols_used=ncols_used,
                beta_coef=cm.beta_coef_of(clustered.compression))
        best = min(best, cost)
    return best


def update_statement_cost(stmt: BulkInsert, config: Configuration,
                          sizes: SizeProvider) -> float:
    total = 0.0
    for idx in config.for_table(stmt.table):
        rows = stmt.nrows
        if idx.predicate is not None:
            t = sizes.schema.tables[idx.table]
            rows = rows * idx.predicate.selectivity(t)
        total += cm.update_cost(sizes.size(idx), sizes.nrows(idx), rows,
                                idx.compression)
    return total


_SAME = object()   # `WhatIfOptimizer.engine`: keep the current engine


class WhatIfOptimizer:
    """Cached what-if cost API (the Figure-1 'query optimizer extension').

    `statement_cost` / `workload_cost` price a statement at a time in
    float64 on the host, cached by (statement, the table's indexes);
    `calls` counts the statements actually priced.  `workload_cost_batch`
    scores many configurations at once through the batched
    `cost_engine.CostEngine` on `device` (None: the float64 NumPy route;
    a torch device: its float32 scorers, where a path has them).
    """

    def __init__(self, workload: Workload, sizes: SizeProvider,
                 device: Optional[torch.device] = None):
        self.workload = workload
        self.sizes = sizes
        self.device = device
        self._cache: Dict[Tuple, float] = {}
        self._engine = None
        self.calls = 0

    def statement_cost(self, stmt: Statement, config: Configuration) -> float:
        relevant = config.for_table(stmt.table)
        key = (stmt.name, tuple(i.key for i in relevant))
        if key not in self._cache:
            self.calls += 1
            if isinstance(stmt, Query):
                c = query_cost(stmt, config, self.sizes)
            else:
                c = update_statement_cost(stmt, config, self.sizes)
            self._cache[key] = c
        return self._cache[key]

    def workload_cost(self, config: Configuration) -> float:
        return sum(s.weight * self.statement_cost(s, config)
                   for s in self.workload.statements)

    def engine(self, device=_SAME):
        """The batched cost engine bound to this optimizer's sizes.

        Built lazily, on the optimizer's device, so every size registered
        on the SizeProvider before the first batched call is picked up
        (sizes registered afterwards are not, as with the statement
        cache).  `engine()` reuses the current engine; `engine(device=d)`
        with another device than the current engine's REBUILDS it from the
        provider's current sizes (registered columns and statement deltas
        do not carry over)."""
        from .cost_engine import CostEngine  # deferred: avoids a cycle
        if device is _SAME:
            if self._engine is None:
                self._engine = CostEngine(self.workload, self.sizes,
                                          device=self.device)
        elif self._engine is None or self._engine.device != device:
            self._engine = CostEngine(self.workload, self.sizes,
                                      device=device)
        return self._engine

    def workload_cost_batch(self, configs: Iterable[Configuration]
                            ) -> np.ndarray:
        """Workload cost of each configuration (float64, aligned with
        `configs`), from the batched engine; `workload_cost` is the
        statement-at-a-time yardstick (the same sums in another order)."""
        return self.engine().config_costs(list(configs))
