"""What-if support: sizes, configurations and budget accounting (paper §1,
§3; the DTA architecture of Figure 1).

A Configuration is a set of IndexDef (one clustered layout per table plus
secondary indexes).  Sizes of compressed structures come from a SizeProvider
fed by the estimation framework (§4-§5); uncompressed sizes are analytic.
Statement costs under a configuration come from the batched
`cost_engine.CostEngine`; the JAX package's scalar statement-at-a-time
optimizer is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, Optional, Tuple

from .compression import uncompressed_payload_bytes
from .relation import IndexDef
from .synopses import Schema
from .workload import Query


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

    def replace(self, old: IndexDef, new: IndexDef) -> "Configuration":
        return Configuration((self.indexes - {old}) | {new})

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


def _partial_applicable(idx: IndexDef, query: Query) -> bool:
    if idx.predicate is None:
        return True
    for p in query.filters:
        if (p.col == idx.predicate.col and p.lo >= idx.predicate.lo
                and p.hi <= idx.predicate.hi):
            return True
    return False
