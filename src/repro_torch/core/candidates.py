"""Candidate selection (paper §6.1): per-query candidates, top-k vs Skyline.

For each query we generate syntactically relevant indexes, produce compressed
variants for each compression method, cost each single-index configuration
with the what-if optimizer, and then select either:

* top-k   — the k lowest-cost configurations (today's DTA behavior), or
* skyline — the full (size, cost) Pareto frontier (the paper's method),
            keeping slow-but-small compressed candidates that top-k prunes.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Sequence, Tuple

from .relation import IndexDef, Table
from .whatif import Configuration, SizeProvider
from .workload import Query

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids an import cycle
    from .cost_engine import CostEngine


@dataclasses.dataclass(frozen=True)
class Candidate:
    index: IndexDef
    size: float
    cost: float  # query cost of base + this index


def syntactically_relevant(query: Query, table: Table,
                           include_clustered: bool = True) -> List[IndexDef]:
    """Indexes worth considering for one query (§6.1).

    - single-column index per filter column,
    - the composite filter-column index (most selective first),
    - the covering index (filters + used columns),
    - compressed clustered-layout variants (include_clustered).
    """
    filters = sorted(query.filters, key=lambda p: p.selectivity(table))
    fcols = [p.col for p in filters]
    out: List[IndexDef] = []
    seen = set()

    def add(cols: Tuple[str, ...], clustered: bool = False):
        if not cols or (cols, clustered) in seen:
            return
        seen.add((cols, clustered))
        out.append(IndexDef(query.table, cols, clustered=clustered))

    for c in fcols:
        add((c,))
    if len(fcols) > 1:
        add(tuple(fcols))
    covering = tuple(dict.fromkeys(fcols + list(query.cols_used)))
    add(covering)
    if include_clustered:
        # clustered layout resorted to lead with the filter columns
        all_cols = tuple(c.name for c in table.columns)
        lead = tuple(dict.fromkeys(list(covering) + list(all_cols)))
        add(lead, clustered=True)
    return out


def expand_with_compression(indexes: Sequence[IndexDef],
                            methods: Sequence[str]) -> List[IndexDef]:
    out: List[IndexDef] = []
    for idx in indexes:
        out.append(idx)
        for m in methods:
            out.append(idx.with_compression(m))
    return out


def cost_candidates(query: Query, cands: Sequence[IndexDef],
                    base: Configuration, sizes: SizeProvider,
                    engine: "CostEngine",
                    precomputed=None) -> List[Candidate]:
    """Cost each single-index configuration for `query`: the whole
    candidate list is scored in one vectorized `CostEngine` pass.
    `precomputed` (an array aligned with `cands`, prefetched by the caller)
    short-circuits the engine call; the caller owns the contract that it
    holds exactly the values the engine would return."""
    costs = (precomputed if precomputed is not None
             else engine.candidate_query_costs(query, base, cands))
    out = []
    for k, idx in enumerate(cands):
        if idx.clustered:
            old = base.clustered(idx.table)
            # clustered replacement "size" = delta vs uncompressed base layout
            size = sizes.size(idx) - (sizes.size(old) if old else 0.0)
        else:
            size = sizes.size(idx)
        out.append(Candidate(index=idx, size=size, cost=float(costs[k])))
    return out


def select_topk(cands: Sequence[Candidate], k: int = 2) -> List[Candidate]:
    """DTA's best-per-query selection (lowest cost wins)."""
    return sorted(cands, key=lambda c: (c.cost, c.size))[:k]


def select_skyline(cands: Sequence[Candidate]) -> List[Candidate]:
    """Pareto frontier of (size, cost) — O(n^2) dominance test (§6.1)."""
    out = []
    for c in cands:
        dominated = False
        for other in cands:
            if other is c:
                continue
            if (other.cost <= c.cost and other.size <= c.size
                    and (other.cost < c.cost or other.size < c.size)):
                dominated = True
                break
        if not dominated:
            out.append(c)
    # deterministic order: small to large
    return sorted(out, key=lambda c: (c.size, c.cost))


MAX_MERGES = 24


def merged_candidates(per_query: Dict[str, List[IndexDef]]
                      ) -> List[IndexDef]:
    """Index merging [8] (Figure 1): merge pairs of same-table candidates
    sharing a leading key column into one index serving both queries, at
    most MAX_MERGES of them.
    Compressed variants of merged objects are generated by the caller (§6.2
    last paragraph)."""
    flat: List[IndexDef] = []
    seen = set()
    for cands in per_query.values():
        for idx in cands:
            if idx.clustered or idx.compression is not None:
                continue
            if idx.key not in seen:
                seen.add(idx.key)
                flat.append(idx)
    out: List[IndexDef] = []
    oseen = set()
    for i, a in enumerate(flat):
        for b in flat[i + 1:]:
            if a.table != b.table or a.cols[0] != b.cols[0]:
                continue
            if set(a.cols) == set(b.cols):
                continue
            merged_cols = tuple(dict.fromkeys(list(a.cols) + list(b.cols)))
            m = IndexDef(a.table, merged_cols)
            if m.key not in oseen and m.key not in seen:
                oseen.add(m.key)
                out.append(m)
            if len(out) >= MAX_MERGES:
                return out
    return out


def skyline_representatives(skyline: Sequence[Candidate],
                            max_points: int) -> List[Candidate]:
    """Cluster the skyline and keep representatives (§6.1 last paragraph)."""
    if len(skyline) <= max_points:
        return list(skyline)
    pts = sorted(skyline, key=lambda c: c.size)
    step = (len(pts) - 1) / (max_points - 1)
    picked = [pts[int(round(i * step))] for i in range(max_points)]
    uniq: Dict[Tuple, Candidate] = {c.index.key: c for c in picked}
    return list(uniq.values())
