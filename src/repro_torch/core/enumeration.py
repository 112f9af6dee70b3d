"""Enumeration (paper §6.2): greedy search over the candidate pool.

Three variants:
* pure      — classic greedy: add the index with the largest workload-cost
              reduction that still fits the budget.
* density   — greedy on benefit/size ratio (DB2-style [15]).
* backtrack — the paper's contribution: pure greedy, but when the best
              choice is OVERSIZED, try to recover it by replacing members
              of the would-be configuration with their compressed variants
              (Figure 8), then compare against the feasible greedy choices.

Clustered candidates replace the table's current clustered layout instead of
being added alongside it.

Two execution paths:

* `greedy_enumerate` drives a repro_torch.core.cost_engine.CostEngine and
  scores the whole pool per greedy step with a few vectorized ops, using
  incremental delta evaluation — a candidate on table T only re-evaluates
  statements on T;
* `greedy_enumerate_scalar` is the statement-at-a-time reference: each
  candidate configuration is priced by a `WhatIfOptimizer`, in float64 on
  the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost_engine import CostEngine, TableEval
from .relation import IndexDef
from .whatif import (Configuration, SizeProvider, WhatIfOptimizer,
                     storage_used)


@dataclasses.dataclass
class EnumerationResult:
    config: Configuration
    cost: float
    used_bytes: float
    steps: List[str]


def _apply(config: Configuration, idx: IndexDef) -> Configuration:
    if idx.clustered:
        old = config.clustered(idx.table)
        return config.replace(old, idx) if old else config.add(idx)
    return config.add(idx)


def _variants_of(idx: IndexDef, pool: Sequence[IndexDef]) -> List[IndexDef]:
    """Compressed variants of `idx` available in the pool."""
    return [p for p in pool
            if p.table == idx.table and p.cols == idx.cols
            and p.clustered == idx.clustered and p.predicate == idx.predicate
            and p.compression != idx.compression
            and p.compression is not None]


def _already_present(config: Configuration, idx: IndexDef) -> bool:
    """An index of the configuration has idx's table, columns, predicate
    and clustering (any method)."""
    for i in config.indexes:
        if (i.table == idx.table and i.cols == idx.cols
                and i.predicate == idx.predicate
                and i.clustered == idx.clustered):
            return True
    return False


MAX_STEPS = 64                  # greedy steps taken at most
SCORE_CHUNK_CELLS = 1 << 22     # matrix cells scored per chunk at most


def greedy_enumerate(engine: CostEngine, sizes: SizeProvider,
                     pool: Sequence[IndexDef], base: Configuration,
                     budget_bytes: float, variant: str = "backtrack"
                     ) -> EnumerationResult:
    """Engine-backed hierarchical greedy: candidates are partitioned by
    table, a step re-scores only the partitions its chosen index touched
    (the `stale` set), and each partition's vectorized scoring runs in
    candidate chunks of at most SCORE_CHUNK_CELLS matrix cells — so the
    peak scratch allocation stays bounded on large workloads.  Chunking is
    value-neutral: every candidate column is scored independently, so the
    results are bit-identical to one monolithic scoring call."""
    if variant not in ("pure", "density", "backtrack"):
        raise ValueError(f"unknown enumeration variant {variant!r}")
    pool = list(pool)
    engine.register(base.indexes)

    config = base
    evals: Dict[str, TableEval] = {
        t: engine.table_eval(config, t) for t in engine.blocks}
    cost = sum(e.total for e in evals.values())
    steps: List[str] = []

    # ---- per-step bookkeeping, precomputed once over the pool ----------
    # engine column ids, per-table candidate index arrays, and an
    # incrementally-maintained already-present mask, so a step never scans
    # the pool against the configuration
    n = len(pool)
    pool_ids = engine.register(pool)
    pool_sizes = np.array([sizes.size(p) for p in pool]) if n else np.zeros(0)
    pool_tables = sorted({p.table for p in pool})

    def sig(idx: IndexDef) -> Tuple:
        # a pool entry is present when an index of the configuration has
        # the same table, columns, predicate and clustering (any method)
        return (idx.table, idx.cols, idx.predicate, idx.clustered)

    sig_to_ks: Dict[Tuple, List[int]] = {}
    for k, p in enumerate(pool):
        sig_to_ks.setdefault(sig(p), []).append(k)
    sec_ks_by_table = {
        t: np.array([k for k, p in enumerate(pool)
                     if p.table == t and not p.clustered], dtype=np.int64)
        for t in pool_tables}
    cl_ks_by_table = {
        t: np.array([k for k, p in enumerate(pool)
                     if p.table == t and p.clustered], dtype=np.int64)
        for t in pool_tables}
    present = np.zeros(n, dtype=bool)

    def recompute_present(cfg: Configuration) -> None:
        present[:] = False
        for idx in cfg.indexes:
            ks = sig_to_ks.get(sig(idx))
            if ks:
                present[ks] = True

    recompute_present(config)

    # per-table benefit/delta-used caches: a greedy step only changes ONE
    # table's configuration, so every other table's scores are reused
    # verbatim (the recomputed values would be bit-identical)
    benefit = np.full(n, -np.inf)
    delta_used = np.zeros(n)
    stale = set(pool_tables)

    def rescore(t: str) -> None:
        c_id, sec_ids = engine.split(config, t)
        cur = evals[t]
        nq = max(1, len(engine.blocks[t].queries))
        all_sec = sec_ks_by_table[t]
        benefit[all_sec] = -np.inf
        sec_ks = all_sec[~present[all_sec]]
        step = max(1, SCORE_CHUNK_CELLS // nq)
        for lo in range(0, sec_ks.size, step):
            ks = sec_ks[lo:lo + step]
            q_tot, upd_delta = engine.score_add_secondary(
                t, c_id, cur.q_cost, pool_ids[ks])
            benefit[ks] = cur.total - (q_tot + cur.u_total + upd_delta)
            delta_used[ks] = pool_sizes[ks]
        all_cl = cl_ks_by_table[t]
        benefit[all_cl] = -np.inf
        cl_ks = all_cl[~present[all_cl]]
        if cl_ks.size:
            old_c = config.clustered(t)
            old_size = sizes.size(old_c) if old_c is not None else 0.0
            # the clustered-swap kernel allocates (nq, n_sec, chunk) paths
            step = max(1, SCORE_CHUNK_CELLS // (nq * max(1, len(sec_ids))))
            for lo in range(0, cl_ks.size, step):
                ks = cl_ks[lo:lo + step]
                q_tot, upd_c = engine.score_replace_clustered(
                    t, sec_ids, pool_ids[ks])
                benefit[ks] = cur.total - (q_tot + upd_c + cur.sec_upd)
                delta_used[ks] = pool_sizes[ks] - old_size

    for _ in range(MAX_STEPS):
        if not n:
            break
        used = storage_used(config, base, sizes)
        for t in sorted(stale):
            rescore(t)
        stale.clear()

        valid = benefit > 1e-9
        if not valid.any():
            break
        if variant == "density":
            score = np.where(valid,
                             benefit / np.maximum(delta_used, 1.0), -np.inf)
        else:
            score = np.where(valid, benefit, -np.inf)
        feasible = valid & (used + delta_used <= budget_bytes)

        best_any_k = int(np.argmax(score))
        best_feas_k: Optional[int] = None
        if feasible.any():
            feas_score = np.where(feasible, score, -np.inf)
            best_feas_k = int(np.argmax(feas_score))

        chosen: Optional[Tuple[IndexDef, Configuration]] = None
        recovered_choice = False
        if variant == "backtrack" and (best_feas_k is None
                                       or best_any_k != best_feas_k):
            # The greedy-best choice is oversized: attempt recovery by
            # swapping members for compressed variants (Figure 8).
            oversized_cfg = _apply(config, pool[best_any_k])
            recovered = _recover_oversized(
                oversized_cfg, base, pool, sizes, engine.config_cost,
                budget_bytes)
            cand_cost = engine.config_cost(recovered) \
                if recovered is not None else float("inf")
            feas_cost = engine.config_cost(
                _apply(config, pool[best_feas_k])) \
                if best_feas_k is not None else float("inf")
            if recovered is not None and cand_cost < min(feas_cost, cost):
                chosen = (pool[best_any_k], recovered)
                recovered_choice = True
                steps.append(
                    f"backtrack-recovered via {pool[best_any_k].label()}")
            elif best_feas_k is not None:
                chosen = (pool[best_feas_k],
                          _apply(config, pool[best_feas_k]))
        elif best_feas_k is not None:
            chosen = (pool[best_feas_k], _apply(config, pool[best_feas_k]))

        if chosen is None:
            break
        config = chosen[1]
        # re-derive the present mask from the new config: a clustered
        # replacement also REMOVES a layout, which can free pool entries
        recompute_present(config)
        if recovered_choice:
            evals = {t: engine.table_eval(config, t) for t in engine.blocks}
            stale.update(pool_tables)
        else:
            t = chosen[0].table
            evals[t] = engine.table_eval(config, t)
            stale.add(t)
        new_cost = sum(e.total for e in evals.values())
        steps.append(f"add {chosen[0].label()}  cost {cost:.1f}->{new_cost:.1f}")
        cost = new_cost

    return EnumerationResult(config=config, cost=cost,
                             used_bytes=storage_used(config, base, sizes),
                             steps=steps)


def greedy_enumerate_scalar(optimizer: WhatIfOptimizer, sizes: SizeProvider,
                            pool: Sequence[IndexDef], base: Configuration,
                            budget_bytes: float, variant: str = "backtrack",
                            max_indexes: int = MAX_STEPS
                            ) -> EnumerationResult:
    """The statement-at-a-time greedy: every step prices each candidate's
    configuration with `optimizer.workload_cost` (float64, on the host)
    and takes the best by `variant`'s rule, `greedy_enumerate`'s choices
    and costs up to the summation order."""
    if variant not in ("pure", "density", "backtrack"):
        raise ValueError(f"unknown enumeration variant {variant!r}")
    config = base
    cost = optimizer.workload_cost(config)
    steps: List[str] = []

    for _ in range(max_indexes):
        used = storage_used(config, base, sizes)
        best_feasible: Optional[Tuple[float, IndexDef, Configuration]] = None
        best_any: Optional[Tuple[float, IndexDef, Configuration]] = None

        for idx in pool:
            if _already_present(config, idx):
                continue
            cfg2 = _apply(config, idx)
            used2 = storage_used(cfg2, base, sizes)
            cost2 = optimizer.workload_cost(cfg2)
            benefit = cost - cost2
            if benefit <= 1e-9:
                continue
            delta_size = max(used2 - used, 1.0)
            score = benefit / delta_size if variant == "density" else benefit
            entry = (score, idx, cfg2)
            if used2 <= budget_bytes:
                if best_feasible is None or score > best_feasible[0]:
                    best_feasible = entry
            if best_any is None or score > best_any[0]:
                best_any = entry

        chosen: Optional[Tuple[IndexDef, Configuration]] = None
        if variant == "backtrack" and best_any is not None and (
                best_feasible is None or best_any[1] != best_feasible[1]):
            # The greedy-best choice is oversized: attempt recovery by
            # swapping members for compressed variants (Figure 8).
            recovered = _recover_oversized(
                best_any[2], base, pool, sizes, optimizer.workload_cost,
                budget_bytes)
            cand_cost = optimizer.workload_cost(recovered) \
                if recovered is not None else float("inf")
            feas_cost = optimizer.workload_cost(best_feasible[2]) \
                if best_feasible is not None else float("inf")
            if recovered is not None and cand_cost < min(feas_cost, cost):
                chosen = (best_any[1], recovered)
                steps.append(f"backtrack-recovered via {best_any[1].label()}")
            elif best_feasible is not None:
                chosen = (best_feasible[1], best_feasible[2])
        elif best_feasible is not None:
            chosen = (best_feasible[1], best_feasible[2])

        if chosen is None:
            break
        config = chosen[1]
        new_cost = optimizer.workload_cost(config)
        steps.append(f"add {chosen[0].label()}  cost {cost:.1f}->{new_cost:.1f}")
        cost = new_cost

    return EnumerationResult(config=config, cost=cost,
                             used_bytes=storage_used(config, base, sizes),
                             steps=steps)


def _recover_oversized(config: Configuration, base: Configuration,
                       pool: Sequence[IndexDef], sizes: SizeProvider,
                       cost_fn: Callable[[Configuration], float],
                       budget_bytes: float) -> Optional[Configuration]:
    """Figure 8: replace members with compressed variants until it fits.

    Considers replacing each index (including repeatedly, cheapest-cost-loss
    first) and returns the fastest configuration that fits, or None.
    `cost_fn` prices a configuration (the engine's `config_cost` or the
    optimizer's `workload_cost`).
    """
    best: Optional[Tuple[float, Configuration]] = None
    frontier = [config]
    seen = {config.indexes}
    for _ in range(4):  # bounded replacement depth
        nxt: List[Configuration] = []
        for cfg in frontier:
            for idx in sorted(cfg.indexes, key=lambda i: i.label()):
                if idx.compression is not None:
                    continue
                for var in _variants_of(idx, pool):
                    cfg2 = cfg.replace(idx, var)
                    if cfg2.indexes in seen:
                        continue
                    seen.add(cfg2.indexes)
                    if storage_used(cfg2, base, sizes) <= budget_bytes:
                        c = cost_fn(cfg2)
                        if best is None or c < best[0]:
                            best = (c, cfg2)
                    else:
                        nxt.append(cfg2)
        if best is not None or not nxt:
            break
        frontier = nxt
    return best[1] if best else None
