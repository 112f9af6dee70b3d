"""Batched what-if cost engine: the advisor hot path as array code.

This module precomputes, per table, the full (statement × access-path)
cost matrix so a greedy step scores the *entire* candidate pool with a
handful of vectorized ops, and so adding an index on table T only
re-evaluates statements on T (incremental delta evaluation).

Decomposition used:

* A query's cost under configuration (c, S) — clustered layout `c` plus
  secondary set `S` — is

      min( SCANC[q, c],  min_{i in S} PATH[q, i, c] )
      PATH[q, i, c] = min( COV[q, i],  SEEK[q, i] + RID[q, i, c] )

  where COV (covering seek/scan) and SEEK (non-covering seek part) depend
  only on the candidate index, and RID (base-table RID lookups) couples the
  candidate with the *current clustered layout* through its page count and
  decompression coefficient.  All terms are evaluated with the ufunc-safe
  functions of repro_torch.core.cost_model.

* A bulk insert's cost is additive over the table's indexes: UPD[u, i].

Backends: with no device (numpy) everything is float64 NumPy, bitwise
equal to the JAX package's numpy backend.  With a torch device the three
greedy-step scoring functions — add-secondary, replace-clustered and
per-query candidate costing — run as float32 torch ops on the device (the
op sequences of the JAX package's `jax.jit` scorers; the weighted sum
`q_w @ new_q` is a float32 `torch.matmul`, which PyTorch runs in full
float32 unless TF32 is switched on).  The cost matrices themselves stay
on the host, as in the reference, and each scoring call copies its
slices to the device in one transfer.

Not ported yet: statement deltas (online sessions), chunked costing and
the fleet's cross-tenant stacked costing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cost_model as cm
from .backend import to_device
from .relation import IndexDef, Predicate, Table
from .whatif import Configuration, SizeProvider, _partial_applicable
from .workload import BulkInsert, Query, Workload

_INF = float("inf")


@dataclasses.dataclass
class TableEval:
    """Evaluated state of one table under a (clustered, secondaries) pair."""
    q_cost: np.ndarray      # per-query cost vector (nq,)
    q_total: float          # weighted query cost
    u_total: float          # weighted update-maintenance cost
    sec_upd: float          # update part contributed by secondaries only

    @property
    def total(self) -> float:
        return self.q_total + self.u_total


class _TableBlock:
    """Cost matrices for all registered access paths of one table.

    Columns (one per registered IndexDef) are stored in capacity-doubling
    arrays; evaluation always addresses them by explicit id lists, so no
    final assembly step is needed.
    """

    def __init__(self, table: Table, queries: Sequence[Query],
                 updates: Sequence[BulkInsert]):
        self.table = table
        self.queries = list(queries)
        self.updates = list(updates)
        nq, nu = len(self.queries), len(self.updates)
        self.q_w = np.array([q.weight for q in self.queries], dtype=np.float64)
        self.u_w = np.array([u.weight for u in self.updates], dtype=np.float64)
        self.u_rows = np.array([float(u.nrows) for u in self.updates])
        self.ncols_used = np.array([len(q.all_cols()) for q in self.queries],
                                   dtype=np.float64)
        # structural per-query caches (covering test and prefix
        # selectivity, without re-deriving them per registration)
        self._q_cols_set = [frozenset(q.all_cols()) for q in self.queries]
        self._q_filt = [{p.col: p for p in q.filters} for q in self.queries]
        self._q_row = {q.name: qi for qi, q in enumerate(self.queries)}
        self._sel_cache: Dict[Predicate, float] = {}
        # dense structural matrices over the table's column universe: the
        # registration-time structural pass (applicability / covering /
        # prefix selectivity) runs as array ops instead of a per-query
        # Python loop, which dominates registration on large workloads
        self._col_pos = {c.name: k for k, c in enumerate(table.columns)}
        ncols_t = len(table.columns)
        self._q_has = np.zeros((nq, ncols_t), dtype=bool)
        self._q_hasf = np.zeros((nq, ncols_t), dtype=bool)
        self._q_selm = np.ones((nq, ncols_t))
        for qi, q in enumerate(self.queries):
            self._fill_struct_row(qi, q)
        self._ids: Dict[Tuple, int] = {}       # IndexDef.key -> column id
        self.n = 0
        self._cap = 0
        self.cov = np.empty((nq, 0))
        self.seek = np.empty((nq, 0))
        self.ridr = np.empty((nq, 0))
        self.scanc = np.empty((nq, 0))
        self.upd = np.empty((nu, 0))
        self.size = np.empty(0)
        self.beta = np.empty(0)
        self.nrows_idx = np.empty(0)

    def _grow(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = max(16, 2 * self._cap, need)
        nq, nu = len(self.queries), len(self.updates)

        def g2(a: np.ndarray, rows: int) -> np.ndarray:
            out = np.empty((rows, cap))
            out[:, :a.shape[1]] = a
            return out

        def g1(a: np.ndarray) -> np.ndarray:
            out = np.empty(cap)
            out[:a.shape[0]] = a
            return out

        self.cov, self.seek = g2(self.cov, nq), g2(self.seek, nq)
        self.ridr, self.scanc = g2(self.ridr, nq), g2(self.scanc, nq)
        self.upd = g2(self.upd, nu)
        self.size, self.beta = g1(self.size), g1(self.beta)
        self.nrows_idx = g1(self.nrows_idx)
        self._cap = cap

    def _sel(self, p: Predicate) -> float:
        s = self._sel_cache.get(p)
        if s is None:
            s = self._sel_cache[p] = p.selectivity(self.table)
        return s

    def _fill_struct_row(self, qi: int, q: Query) -> None:
        """One query's row of the structural matrices: which columns the
        query touches, which carry a filter, and that filter's selectivity
        (last predicate per column wins)."""
        pos = self._col_pos
        for c in q.all_cols():
            self._q_has[qi, pos[c]] = True
        for c, p in self._q_filt[qi].items():
            self._q_hasf[qi, pos[c]] = True
            self._q_selm[qi, pos[c]] = self._sel(p)

    # -- registration ----------------------------------------------------
    def has(self, idx: IndexDef) -> bool:
        return idx.key in self._ids

    def id_of(self, idx: IndexDef) -> int:
        return self._ids[idx.key]

    def query_row(self, query: Query) -> int:
        return self._q_row[query.name]

    def add(self, idx: IndexDef, sizes: SizeProvider) -> int:
        j = self._ids.get(idx.key)
        if j is not None:
            return j
        j = self.n
        self._grow(j + 1)
        self._ids[idx.key] = j
        self.n += 1
        self._fill_column(j, idx, sizes)
        return j

    def _fill_column(self, j: int, idx: IndexDef,
                     sizes: SizeProvider) -> None:
        """Compute column `j` from the provider's current sizes."""
        t = self.table
        size = float(sizes.size(idx))
        nrows_idx = float(sizes.nrows(idx))
        nq = len(self.queries)
        self.size[j] = size
        self.beta[j] = cm.beta_coef_of(idx.compression)
        self.nrows_idx[j] = nrows_idx

        if idx.clustered:
            # clustered layout: the full scan path
            self.scanc[:, j] = cm.scan_cost(size, t.nrows, self.ncols_used,
                                            idx.compression)
            self.cov[:, j] = _INF
            self.seek[:, j] = _INF
            self.ridr[:, j] = 0.0
        else:
            self.scanc[:, j] = _INF
            # structural pass: applicability / covering / prefix selectivity
            if idx.predicate is None:
                # vectorized over the structural matrices.  The prefix
                # selectivity multiplies column-by-column in idx.cols
                # order — the same IEEE operation order as the scalar
                # loop, so the resulting values are bit-identical.
                ids = [self._col_pos[c] for c in idx.cols]
                applicable = np.ones(nq, dtype=bool)
                in_idx = np.zeros(len(self._col_pos), dtype=bool)
                in_idx[ids] = True
                covers = ~(self._q_has & ~in_idx).any(axis=1)
                prefix = np.logical_and.accumulate(self._q_hasf[:, ids],
                                                   axis=1)
                sel = np.ones(nq)
                for pos, ci in enumerate(ids):
                    m = prefix[:, pos]
                    sel[m] *= self._q_selm[m, ci]
            else:
                sel = np.ones(nq)
                applicable = np.ones(nq, dtype=bool)
                covers = np.zeros(nq, dtype=bool)
                cols_set = set(idx.cols)
                for qi, q in enumerate(self.queries):
                    if not _partial_applicable(idx, q):
                        applicable[qi] = False
                        continue
                    covers[qi] = self._q_cols_set[qi] <= cols_set
                    filt = self._q_filt[qi]
                    s, matched = 1.0, False
                    for c in idx.cols:
                        p = filt.get(c)
                        if p is None:
                            break
                        s *= self._sel(p)
                        matched = True
                    sel[qi] = s if matched else 1.0
            # vectorized cost pass over the structural masks
            cov = np.full(nq, _INF)
            seek = np.full(nq, _INF)
            ridr = np.zeros(nq)
            m = applicable & covers & (sel < 1.0)
            cov[m] = cm.seek_cost(size, nrows_idx, sel[m],
                                  self.ncols_used[m], idx.compression)
            m = applicable & covers & (sel >= 1.0)
            cov[m] = cm.scan_cost(size, nrows_idx, self.ncols_used[m],
                                  idx.compression)
            m = applicable & ~covers & (sel < 1.0)
            seek[m] = cm.seek_cost(size, nrows_idx, sel[m],
                                   float(len(idx.cols)), idx.compression)
            ridr[m] = nrows_idx * sel[m]
            self.cov[:, j] = cov
            self.seek[:, j] = seek
            self.ridr[:, j] = ridr

        if self.updates:
            rows = self.u_rows
            if idx.predicate is not None:
                rows = rows * self._sel(idx.predicate)
            self.upd[:, j] = cm.update_cost(size, nrows_idx, rows,
                                            idx.compression)

    # -- evaluation ------------------------------------------------------
    def rid(self, ids, c: int) -> np.ndarray:
        """RID-lookup matrix (nq, len(ids)) under clustered layout `c`."""
        return cm.rid_lookup_cost(self.ridr[:, ids], self.size[c],
                                  ncols_used=self.ncols_used[:, None],
                                  beta_coef=self.beta[c])

    def paths(self, ids, c: int) -> np.ndarray:
        """Best per-query path cost (nq, len(ids)) via each secondary id."""
        return np.minimum(self.cov[:, ids],
                          self.seek[:, ids] + self.rid(ids, c))

    def eval(self, c: int, sec_ids: Sequence[int]) -> TableEval:
        q = self.scanc[:, c].copy()
        if len(sec_ids) and len(self.queries):
            q = np.minimum(q, self.paths(list(sec_ids), c).min(axis=1))
        q_total = float(self.q_w @ q) if len(self.queries) else 0.0
        sec_upd = 0.0
        u_total = 0.0
        if len(self.updates):
            u_vec = self.upd[:, c].copy()
            if len(sec_ids):
                sec_vec = self.upd[:, list(sec_ids)].sum(axis=1)
                sec_upd = float(self.u_w @ sec_vec)
                u_vec = u_vec + sec_vec
            u_total = float(self.u_w @ u_vec)
        return TableEval(q_cost=q, q_total=q_total, u_total=u_total,
                         sec_upd=sec_upd)


# ---------------------------------------------------------------------------
# float32 device scoring (the torch backend)
# ---------------------------------------------------------------------------

def _pages_f32(size: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(size, 0.0) / cm.PAGE_BYTES


def _score_secondary_torch(cur_q, cov, seek, ridr, size_c, beta_c,
                           ncols_used, q_w):
    """New weighted query totals when each candidate secondary is added."""
    npages = _pages_f32(size_c)
    rid = (cm.T_IO_RAND * torch.minimum(ridr, npages)
           + cm.CPU_ROW * ridr
           + beta_c * ridr * ncols_used[:, None])
    path = torch.minimum(cov, seek + rid)
    new_q = torch.minimum(cur_q[:, None], path)
    return q_w @ new_q


def _score_replace_torch(scanc_c, cov, seek, ridr, size_c, beta_c,
                         ncols_used, q_w):
    """Clustered-replacement scoring: every kept secondary path under every
    candidate clustered layout.  scanc_c (nq, m) candidate scan costs;
    cov/seek/ridr (nq, ns) the kept-secondary rows; size_c/beta_c (m,)
    the candidate layouts' RID coupling."""
    npages = _pages_f32(size_c)                                   # (m,)
    r3 = ridr[:, :, None]
    rid = (cm.T_IO_RAND * torch.minimum(r3, npages)
           + cm.CPU_ROW * r3
           + beta_c * r3 * ncols_used[:, None, None])
    path = torch.minimum(cov[:, :, None], seek[:, :, None] + rid)
    new_q = torch.minimum(scanc_c, path.amin(dim=1))
    return q_w @ new_q


def _cand_costs_torch(scan_l, cov_s, seek_s, ridr_s, size_l, beta_l,
                      cov_k, seek_k, ridr_k, size_c, beta_c, ncq, is_sec):
    """Per-query candidate costing (one query row, m candidates).  Each
    candidate k is scored under its own layout L_k (the current clustered
    layout for secondary candidates, the candidate itself for clustered
    ones): min(scan under L_k, best base-secondary path under L_k, own
    path under the current layout when secondary)."""
    npag_l = _pages_f32(size_l)                                   # (m,)
    rs = ridr_s[:, None]
    rid_sl = (cm.T_IO_RAND * torch.minimum(rs, npag_l)
              + cm.CPU_ROW * rs + beta_l * rs * ncq)              # (ns, m)
    if cov_s.numel():
        base_path = torch.minimum(cov_s[:, None],
                                  seek_s[:, None] + rid_sl).amin(dim=0)
    else:
        base_path = torch.full_like(scan_l, _INF)
    npag_c = _pages_f32(size_c)
    rid_k = (cm.T_IO_RAND * torch.minimum(ridr_k, npag_c)
             + cm.CPU_ROW * ridr_k + beta_c * ridr_k * ncq)       # (m,)
    own = torch.where(is_sec != 0, torch.minimum(cov_k, seek_k + rid_k),
                      torch.full_like(cov_k, _INF))
    return torch.minimum(torch.minimum(scan_l, base_path), own)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


class CostEngine:
    """Batched what-if engine over a workload and a SizeProvider.

    Register any IndexDef once; afterwards every cost query — single
    configurations, configuration batches, or whole-pool greedy-step scores —
    is evaluated from the precomputed per-table matrices.
    """

    def __init__(self, workload: Workload, sizes: SizeProvider,
                 device: Optional[torch.device] = None):
        self.device = device
        self.workload = workload
        self.sizes = sizes
        self.blocks: Dict[str, _TableBlock] = {}
        for name, table in workload.schema.tables.items():
            qs = [s for s in workload.statements
                  if isinstance(s, Query) and s.table == name]
            us = [s for s in workload.statements
                  if isinstance(s, BulkInsert) and s.table == name]
            self.blocks[name] = _TableBlock(table, qs, us)

    # -- registration ----------------------------------------------------
    def register(self, idxs: Iterable[IndexDef]) -> np.ndarray:
        """Register every index; returns their engine column ids aligned
        with the input (so callers can precompute id arrays once instead
        of calling `id_of` per candidate per greedy step)."""
        return np.array([self.blocks[idx.table].add(idx, self.sizes)
                         for idx in idxs], dtype=np.int64)

    def id_of(self, idx: IndexDef) -> int:
        blk = self.blocks[idx.table]
        if not blk.has(idx):
            blk.add(idx, self.sizes)
        return blk.id_of(idx)

    # -- configuration costing -------------------------------------------
    def split(self, config: Configuration, table: str
              ) -> Tuple[int, List[int]]:
        blk = self.blocks[table]
        c_id = None
        sec: List[int] = []
        for idx in config.indexes:
            if idx.table != table:
                continue
            if not blk.has(idx):
                blk.add(idx, self.sizes)
            if idx.clustered:
                assert c_id is None, f"two clustered layouts for {table}"
                c_id = blk.id_of(idx)
            else:
                sec.append(blk.id_of(idx))
        assert c_id is not None, f"no clustered layout for {table}"
        return c_id, sec

    def table_eval(self, config: Configuration, table: str) -> TableEval:
        c_id, sec = self.split(config, table)
        return self.blocks[table].eval(c_id, sec)

    def config_cost(self, config: Configuration) -> float:
        """Workload cost of one configuration (parity with the scalar
        `WhatIfOptimizer.workload_cost`, modulo summation order)."""
        total = 0.0
        for table, blk in self.blocks.items():
            if not blk.queries and not blk.updates:
                continue
            total += self.table_eval(config, table).total
        return total

    # -- per-query candidate costing (candidate selection, §6.1) ----------
    def candidate_query_costs(self, query: Query, base: Configuration,
                              cands: Sequence[IndexDef]) -> np.ndarray:
        """Cost of `query` under base + each single candidate, batched.

        Mirrors the scalar `cost_candidates` loop: secondary candidates are
        added on top of `base`; clustered candidates replace the table's
        clustered layout.  Returns one cost per candidate, aligned with
        `cands`.
        """
        table = query.table
        blk = self.blocks[table]
        self.register(cands)
        c_id, sec_ids = self.split(base, table)
        qi = blk.query_row(query)
        ncq = blk.ncols_used[qi]

        def row_paths(ids, c):
            # single-query row of paths(): same formula, O(len(ids))
            rid = cm.rid_lookup_cost(blk.ridr[qi, ids], blk.size[c],
                                     ncols_used=ncq, beta_coef=blk.beta[c])
            return np.minimum(blk.cov[qi, ids], blk.seek[qi, ids] + rid)

        if self.device is not None and len(cands):
            ids = np.array([blk.id_of(i) for i in cands], dtype=np.int64)
            is_sec = np.array([not i.clustered for i in cands])
            cl_ids = np.where(is_sec, c_id, ids)  # layout each k runs under
            sids = np.array(sec_ids, dtype=np.int64)
            return _host(_cand_costs_torch(*to_device(
                [blk.scanc[qi, cl_ids], blk.cov[qi, sids],
                 blk.seek[qi, sids], blk.ridr[qi, sids], blk.size[cl_ids],
                 blk.beta[cl_ids], blk.cov[qi, ids], blk.seek[qi, ids],
                 blk.ridr[qi, ids], blk.size[c_id], blk.beta[c_id],
                 ncq, is_sec], np.float32, self.device)))

        base_q = blk.scanc[qi, c_id]
        if sec_ids:
            base_q = min(base_q, float(row_paths(sec_ids, c_id).min()))

        out = np.empty(len(cands))
        sec_ks = [k for k, idx in enumerate(cands) if not idx.clustered]
        if sec_ks:
            ids = [blk.id_of(cands[k]) for k in sec_ks]
            out[sec_ks] = np.minimum(base_q, row_paths(ids, c_id))
        for k, idx in enumerate(cands):
            if not idx.clustered:
                continue
            cid2 = blk.id_of(idx)
            c = blk.scanc[qi, cid2]
            if sec_ids:
                c = min(c, float(row_paths(sec_ids, cid2).min()))
            out[k] = c
        return out

    # -- greedy-step scoring ---------------------------------------------
    def score_add_secondary(self, table: str, c_id: int, cur_q: np.ndarray,
                            cand_ids: Sequence[int]
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Score adding each candidate secondary id on top of the current
        state.  Returns (new weighted query totals, update-cost deltas),
        one entry per candidate, in one shot."""
        blk = self.blocks[table]
        ids = list(cand_ids)
        if blk.queries:
            if self.device is not None:
                q_tot = _host(_score_secondary_torch(*to_device(
                    [cur_q, blk.cov[:, ids], blk.seek[:, ids],
                     blk.ridr[:, ids], blk.size[c_id], blk.beta[c_id],
                     blk.ncols_used, blk.q_w], np.float32, self.device)))
            else:
                new_q = np.minimum(cur_q[:, None], blk.paths(ids, c_id))
                q_tot = blk.q_w @ new_q
        else:
            q_tot = np.zeros(len(ids))
        if blk.updates:
            upd_delta = blk.u_w @ blk.upd[:, ids]
        else:
            upd_delta = np.zeros(len(ids))
        return q_tot, upd_delta

    def score_replace_clustered(self, table: str, sec_ids: Sequence[int],
                                cand_ids: Sequence[int]
                                ) -> Tuple[np.ndarray, np.ndarray]:
        """Score swapping the clustered layout to each candidate id, keeping
        the current secondary set.  Returns (new weighted query totals,
        new clustered-update totals) per candidate."""
        blk = self.blocks[table]
        cids = list(cand_ids)
        sids = list(sec_ids)
        if blk.queries:
            if self.device is not None and sids:
                q_tot = _host(_score_replace_torch(*to_device(
                    [blk.scanc[:, cids], blk.cov[:, sids],
                     blk.seek[:, sids], blk.ridr[:, sids], blk.size[cids],
                     blk.beta[cids], blk.ncols_used, blk.q_w],
                    np.float32, self.device)))
            else:
                new_q = blk.scanc[:, cids]                  # (nq, m)
                if sids:
                    # (nq, ns, m): every secondary path under every new
                    # layout
                    rid = cm.rid_lookup_cost(
                        blk.ridr[:, sids, None], blk.size[cids],
                        ncols_used=blk.ncols_used[:, None, None],
                        beta_coef=blk.beta[cids])
                    path = np.minimum(blk.cov[:, sids, None],
                                      blk.seek[:, sids, None] + rid)
                    new_q = np.minimum(new_q, path.min(axis=1))
                q_tot = blk.q_w @ new_q
        else:
            q_tot = np.zeros(len(cids))
        if blk.updates:
            upd_c = blk.u_w @ blk.upd[:, cids]
        else:
            upd_c = np.zeros(len(cids))
        return q_tot, upd_c
