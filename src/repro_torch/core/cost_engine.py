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
op sequences of the JAX package's `jax.jit` scorers).  The weighted sum
`q_w @ new_q` is not a BLAS call: XLA's CPU dot sums a vector-matrix
product in an order LLVM picks by shape (its vectorized query loop:
lanes of float32 fused multiply-adds, interleaved accumulators, a vector
epilogue, a scalar chain; from 4,096 queries XLA's own GEMV, one chain a
candidate), and a BLAS library picks its own order per CPU branch, which
moves the greedy's near-zero benefits across its threshold.
`_xla_sum_order` describes that loop for each shape, read off XLA's
dumps, and `_fma_chain` / `_rid_f32` compute it exactly, with the same
ops on the CPU and the card, so the totals are the JAX package's bit for
bit where the rule holds.
The cost matrices themselves stay on the host, as in the reference, and
each scoring call copies its slices to the device in one transfer.

Online sessions keep one engine across workload deltas (`apply_delta`,
`sync_sizes`): removed statements' rows are dropped, reweights touch only
the weight vectors, added statements append one row across every
registered column, and columns whose registered size changed are refilled.
Rows stay in the workload's statement order, so the matrices equal a
fresh engine's on the resulting workload, and the device scorers, which
gather the candidates' columns by id, get the same operands.

The fleet's cost phase scores many tenants' (query, candidates) jobs in
one stacked pass (`cost_job_arrays` + `batched_candidate_costs`): per
element the arithmetic of `candidate_query_costs` for a secondary-free
base, so a job scored in a fleet batch equals the per-job call bitwise
on each backend.

Not ported yet: chunked costing.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Tuple)

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
        self._u_row = {u.name: ui for ui, u in enumerate(self.updates)}
        self._ids: Dict[Tuple, int] = {}       # IndexDef.key -> column id
        self._defs: List[IndexDef] = []
        self._col_sets: List[Optional[frozenset]] = []  # None for clustered
        self.n = 0
        self._cap = 0
        self.cov = np.empty((nq, 0))
        self.seek = np.empty((nq, 0))
        self.ridr = np.empty((nq, 0))
        self.scanc = np.empty((nq, 0))
        self.upd = np.empty((nu, 0))
        self.size = np.empty(0)
        self.beta = np.empty(0)
        self.alpha = np.empty(0)
        self.nrows_idx = np.empty(0)
        self.col_klen = np.empty(0)

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
        self.alpha, self.nrows_idx = g1(self.alpha), g1(self.nrows_idx)
        self.col_klen = g1(self.col_klen)
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
        self._defs.append(idx)
        self._col_sets.append(None if idx.clustered else frozenset(idx.cols))
        self.n += 1
        self._fill_column(j, idx, sizes)
        return j

    def _fill_column(self, j: int, idx: IndexDef,
                     sizes: SizeProvider) -> None:
        """(Re)compute column `j` from the provider's current sizes: at
        registration, and when a later estimation round changed the
        registered size of an already-registered access path."""
        t = self.table
        size = float(sizes.size(idx))
        nrows_idx = float(sizes.nrows(idx))
        nq = len(self.queries)
        self.size[j] = size
        self.beta[j] = cm.beta_coef_of(idx.compression)
        self.alpha[j] = cm.alpha_coef_of(idx.compression)
        self.nrows_idx[j] = nrows_idx
        self.col_klen[j] = float(len(idx.cols))

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

    def refresh_sizes(self, sizes: SizeProvider) -> int:
        """Refill every column whose provider size changed; returns how
        many columns were recomputed."""
        changed = 0
        for j, idx in enumerate(self._defs):
            if float(sizes.size(idx)) != self.size[j]:
                self._fill_column(j, idx, sizes)
                changed += 1
        return changed

    # -- statement mutation (online sessions) ----------------------------
    def _query_row(self, q: Query) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray]:
        """(cov, seek, ridr, scanc) entries of one new query row for ALL
        registered columns: the transpose of `_fill_column`'s per-query
        pass, with the same elementwise cost-model calls, so an appended
        row is bit-identical to a fresh block's row."""
        cap, n = self._cap, self.n
        cov = np.full(cap, _INF)
        seek = np.full(cap, _INF)
        ridr = np.zeros(cap)
        scanc = np.full(cap, _INF)
        if n == 0:
            return cov, seek, ridr, scanc
        ncq = float(len(q.all_cols()))
        qset = frozenset(q.all_cols())
        filt = {p.col: p for p in q.filters}
        sel = np.ones(n)
        applicable = np.ones(n, dtype=bool)
        covers = np.zeros(n, dtype=bool)
        cl = np.zeros(n, dtype=bool)
        for j, idx in enumerate(self._defs):
            if idx.clustered:
                cl[j] = True
                continue
            if idx.predicate is not None and not _partial_applicable(idx, q):
                applicable[j] = False
                continue
            covers[j] = qset <= self._col_sets[j]
            s, matched = 1.0, False
            for c in idx.cols:
                p = filt.get(c)
                if p is None:
                    break
                s *= self._sel(p)
                matched = True
            sel[j] = s if matched else 1.0
        t = self.table
        ids = np.nonzero(cl)[0]
        if ids.size:
            scanc[ids] = cm.scan_cost(self.size[ids], t.nrows, ncq,
                                      beta_coef=self.beta[ids])
        sec = ~cl
        ids = np.nonzero(sec & applicable & covers & (sel < 1.0))[0]
        if ids.size:
            cov[ids] = cm.seek_cost(self.size[ids], self.nrows_idx[ids],
                                    sel[ids], ncq, beta_coef=self.beta[ids])
        ids = np.nonzero(sec & applicable & covers & (sel >= 1.0))[0]
        if ids.size:
            cov[ids] = cm.scan_cost(self.size[ids], self.nrows_idx[ids],
                                    ncq, beta_coef=self.beta[ids])
        ids = np.nonzero(sec & applicable & ~covers & (sel < 1.0))[0]
        if ids.size:
            seek[ids] = cm.seek_cost(self.size[ids], self.nrows_idx[ids],
                                     sel[ids], self.col_klen[ids],
                                     beta_coef=self.beta[ids])
            ridr[ids] = self.nrows_idx[ids] * sel[ids]
        return cov, seek, ridr, scanc

    def _update_row(self, u: BulkInsert) -> np.ndarray:
        row = np.zeros(self._cap)
        n = self.n
        if n == 0:
            return row
        rows_w = np.full(n, float(u.nrows))
        for j, idx in enumerate(self._defs):
            if idx.predicate is not None:
                rows_w[j] = rows_w[j] * self._sel(idx.predicate)
        row[:n] = cm.update_cost(self.size[:n], self.nrows_idx[:n], rows_w,
                                 alpha_coef=self.alpha[:n])
        return row

    def add_statement(self, s) -> None:
        """Append one statement row across all registered columns."""
        self.add_statements([s])

    def add_statements(self, stmts: Sequence) -> None:
        """Append a batch of statement rows with ONE concatenate per
        matrix.  A new row is a pure function of the registered columns
        (rows never read other rows), so a batch equals appending the
        statements one at a time."""
        qs = [s for s in stmts if isinstance(s, Query)]
        us = [s for s in stmts if not isinstance(s, Query)]
        if qs:
            rows = [self._query_row(q) for q in qs]
            base = len(self.queries)
            nc = len(self._col_pos)
            for i, q in enumerate(qs):
                self.queries.append(q)
                self._q_row[q.name] = base + i
                self._q_cols_set.append(frozenset(q.all_cols()))
                self._q_filt.append({p.col: p for p in q.filters})
            self.q_w = np.append(self.q_w, [float(q.weight) for q in qs])
            self.ncols_used = np.append(
                self.ncols_used, [float(len(q.all_cols())) for q in qs])
            self._q_has = np.concatenate(
                [self._q_has, np.zeros((len(qs), nc), dtype=bool)], axis=0)
            self._q_hasf = np.concatenate(
                [self._q_hasf, np.zeros((len(qs), nc), dtype=bool)], axis=0)
            self._q_selm = np.concatenate(
                [self._q_selm, np.ones((len(qs), nc))], axis=0)
            for i, q in enumerate(qs):
                self._fill_struct_row(base + i, q)
            self.cov = np.concatenate(
                [self.cov, np.stack([r[0] for r in rows])], axis=0)
            self.seek = np.concatenate(
                [self.seek, np.stack([r[1] for r in rows])], axis=0)
            self.ridr = np.concatenate(
                [self.ridr, np.stack([r[2] for r in rows])], axis=0)
            self.scanc = np.concatenate(
                [self.scanc, np.stack([r[3] for r in rows])], axis=0)
        if us:
            rows_u = [self._update_row(u) for u in us]
            base = len(self.updates)
            for i, u in enumerate(us):
                self.updates.append(u)
                self._u_row[u.name] = base + i
            self.u_w = np.append(self.u_w, [float(u.weight) for u in us])
            self.u_rows = np.append(self.u_rows,
                                    [float(u.nrows) for u in us])
            self.upd = np.concatenate([self.upd, np.stack(rows_u)], axis=0)

    def remove_statements(self, names) -> int:
        """Drop the rows of the named statements (no recomputation; the
        surviving rows keep their values and relative order, as a fresh
        block on the shrunk workload has them)."""
        removed = 0
        qkeep = [i for i, q in enumerate(self.queries)
                 if q.name not in names]
        if len(qkeep) != len(self.queries):
            removed += len(self.queries) - len(qkeep)
            ii = np.array(qkeep, dtype=np.int64)
            self.queries = [self.queries[i] for i in qkeep]
            self.q_w = self.q_w[ii]
            self.ncols_used = self.ncols_used[ii]
            self._q_cols_set = [self._q_cols_set[i] for i in qkeep]
            self._q_filt = [self._q_filt[i] for i in qkeep]
            self._q_row = {q.name: qi for qi, q in enumerate(self.queries)}
            self._q_has, self._q_hasf = self._q_has[ii], self._q_hasf[ii]
            self._q_selm = self._q_selm[ii]
            self.cov, self.seek = self.cov[ii], self.seek[ii]
            self.ridr, self.scanc = self.ridr[ii], self.scanc[ii]
        ukeep = [i for i, u in enumerate(self.updates)
                 if u.name not in names]
        if len(ukeep) != len(self.updates):
            removed += len(self.updates) - len(ukeep)
            ii = np.array(ukeep, dtype=np.int64)
            self.updates = [self.updates[i] for i in ukeep]
            self.u_w = self.u_w[ii]
            self.u_rows = self.u_rows[ii]
            self._u_row = {u.name: ui for ui, u in enumerate(self.updates)}
            self.upd = self.upd[ii]
        return removed

    def reweight(self, name: str, w: float) -> bool:
        qi = self._q_row.get(name)
        if qi is not None:
            self.queries[qi] = dataclasses.replace(self.queries[qi],
                                                   weight=w)
            self.q_w[qi] = w
            return True
        ui = self._u_row.get(name)
        if ui is not None:
            self.updates[ui] = dataclasses.replace(self.updates[ui],
                                                   weight=w)
            self.u_w[ui] = w
            return True
        return False

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


# float64 bit patterns: the 29 low mantissa bits that float32 drops, and
# their value on a float32 midpoint; float32's smallest normal and largest
# finite magnitudes
_LOW29 = (1 << 29) - 1
_HALF29 = 1 << 28
_F32_MIN = 2.0 ** -126
_F32_MAX = (2.0 - 2.0 ** -23) * 2.0 ** 127


def _rn32_add(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """float32 round-to-nearest of `a + p`, exactly, in float64 ops.

    `a` holds float32 values and `p` products of two float32 values (exact
    in float64).  A float64 sum rounded again to float32 can round twice
    the wrong way, so the float64 sum is first made round-to-odd: its
    error `e` (TwoSum, exact) moves an inexact sum with an even last bit
    one ulp toward the exact value.  53 >= 24 + 2 bits make the second
    rounding correct.  Returns the float32 result held in float64."""
    s = a + p
    bb = s - a
    e = torch.nan_to_num((a - (s - bb)) + (p - bb), nan=0.0, posinf=0.0,
                         neginf=0.0)                  # 0 where s is inf
    inexact = e != 0
    toward_zero = (torch.signbit(e) ^ torch.signbit(s)) & inexact
    bits = (s.view(torch.int64) - toward_zero.long()) | inexact.long()
    return bits.view(torch.float64).float().double()


def _fma_chain(q_w: torch.Tensor, new_q: torch.Tensor,
               init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`q_w @ new_q` over the leading (query) axis as a sequential float32
    FMA chain: acc = fma(q_w[i], new_q[i], acc) for i in order, from
    `init` (0 by default), rounded to float32 at each step.  q_w (k, *l)
    broadcasts against new_q (k, *l, m) -> (*l, m) float32.

    Each step adds the exact float64 product to the float32 accumulator in
    float64 and rounds to float32: two ops a query.  That second rounding
    is exact unless the float64 sum fell on a float32 midpoint (or left
    float32's normal range), where it may have been rounded there from
    either side; the sums are checked once at the end, and a chain that
    met such a sum is computed again with `_rn32_add`."""
    w = q_w.double().reshape(q_w.shape + (1,) * (new_q.dim() - q_w.dim()))
    p = w * new_q.double()                              # exact products
    start = (torch.zeros(new_q.shape[1:], dtype=torch.float32,
                         device=new_q.device) if init is None else init)
    sums = torch.empty_like(p)
    acc = start
    for p_i, s_i in zip(p.unbind(0), sums.unbind(0)):
        torch.add(acc, p_i, out=s_i)
        acc = s_i.float()
    mag = sums.abs()
    hazard = ((sums.view(torch.int64) & _LOW29) == _HALF29) | \
        ((mag < _F32_MIN) & (mag != 0)) | (mag > _F32_MAX)
    if bool(hazard.any()):
        exact = start.double()
        for p_i in p.unbind(0):
            exact = _rn32_add(exact, p_i)
        acc = exact.float()
    return acc


def _mul_add_chain(q_w: torch.Tensor, new_q: torch.Tensor) -> torch.Tensor:
    """`q_w @ new_q` (k,) x (k, m) -> (m,) as a sequential float32 chain
    from the first product, each product rounded before its add."""
    p = q_w[:, None] * new_q
    acc = p[0]
    for p_i in p[1:].unbind(0):
        acc = acc + p_i
    return acc


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """float32 fma(a, b, c) of float32 operands, exactly (`_rn32_add`)."""
    return _rn32_add(c.double(), a.double() * b.double()).float()


_T_IO_RAND32 = torch.tensor(cm.T_IO_RAND, dtype=torch.float32)
_CPU_ROW32 = torch.tensor(cm.CPU_ROW, dtype=torch.float32)


def _rid_f32(r, npages, beta, ncols, form: str) -> torch.Tensor:
    """The RID-lookup term T_IO_RAND * min(r, npages) + CPU_ROW * r +
    (beta * r) * ncols in float32 as XLA's CPU code computes it: LLVM
    contracts each multiply that feeds an add into an FMA.  Form "A"
    contracts T_IO_RAND * min into the first add (CPU_ROW * r is a value
    computed in another block, a hoisted or broadcast operand), form "B"
    contracts CPU_ROW * r (both products in the add's block; the first
    operand fuses).  Both then fuse (beta * r) * ncols into the second."""
    t = _T_IO_RAND32.to(r.device)
    c = _CPU_ROW32.to(r.device)
    mn = torch.minimum(r, npages)
    if form == "A":
        inner = _fma32(mn, t, c * r)
    else:
        inner = _fma32(r, c, t * mn)
    return _fma32(beta * r, ncols, inner)


class _Part(NamedTuple):
    """`n` consecutive queries of `q_w @ new_q` as one loop of XLA's CPU
    code sums them: `lanes` float32 lanes (1: a scalar chain), `accs`
    interleaved accumulators of them, the vector loop fully `unrolled` or
    not, and the RID term in `form` (`_rid_f32`).  A first chain that is
    not `fused` rounds the last candidate's products before it adds them
    (`_gemv_order`)."""
    lanes: int
    accs: int
    n: int
    unrolled: bool
    form: str
    fused: bool = True


_UNIT, _G56, _WIDE = (1, 1, 1, 1), (2, 2, 2, 1), (2, 3, 2, 1)


def _loop_class(scorer: str, m: int, ns: int
                ) -> Tuple[Tuple[int, ...], int, int, int]:
    """The query loop's class, read off XLA's dumps as `_xla_sum_order`
    says: (LLVM's loop-vectorizer cost of one iteration at VF 1, 2, 4 and
    8; its most interleaved accumulators; the most accumulators x vector
    iterations LLVM still fully unrolls, without and with a vector
    epilogue).  The costs are the smallest integers that give the factors
    LLVM chose at every nq from 16 to 200 (only comparisons count).  The
    strided candidate loads set the class: m = 1 unit stride, m = 2..8 an
    interleave group (5 and 6 cost apart), m > 8 one load a lane ("wide");
    the replace scorer's ns kept secondaries set the loop body, and so its
    interleave count and unroll limits."""
    wide = m > 8
    if scorer == "sec" or ns == 1:
        costs = _WIDE if wide else _G56 if m in (5, 6) else _UNIT
        if scorer == "sec":
            unroll = 4 if wide else 8 if m >= 7 else 12
        else:
            unroll = 8 if wide else 12
        return costs, 4, unroll, unroll
    if ns == 2:
        return _WIDE, 2, (4 if wide else 6), (4 if wide else 6)
    if ns == 3:
        return (1, 2, 1, 1), 2, 4, 4
    if ns <= 6:
        unroll = {4: 3 if wide else 4,
                  5: 2 if wide or m >= 7 else 3, 6: 2}[ns]
        return _UNIT, 1, unroll, unroll
    if ns <= 8:
        unroll = 1 if 2 <= m <= 8 else 0
        return (3, 2, 2, 2), 1, unroll, unroll
    return _WIDE, 2, (0 if 2 <= m <= 8 else 2), 0


def _pick_vf(tc: int, costs: Sequence[int], vfs: Sequence[int]) -> int:
    """LLVM's choice of a vectorization factor for a known trip count: from
    vfs[0] on, a later factor replaces the choice where its cost (vector
    iterations, then the scalar remainder) is strictly lower."""
    def cost(vf):
        return costs[vf.bit_length() - 1] * (tc // vf) + costs[0] * (tc % vf)
    best = vfs[0]
    for vf in vfs[1:]:
        if cost(vf) < cost(best):
            best = vf
    return best


def _vector_plan(nq: int, costs, gaps: int, max_ic: int
                 ) -> Tuple[int, int, int, int, int]:
    """LLVM's vectorized query loop for a trip count of nq >= 16: (VF,
    interleave count, queries in the main vector loop, epilogue VF, queries
    in the vector epilogue).  An interleave group with gaps (stride 2..8,
    gaps = 1) leaves at least one query to the scalar remainder.  The main
    VF starts from the scalar loop, the epilogue's from its narrowest
    candidate."""
    vf = _pick_vf(nq, costs, (1, 2, 4, 8))
    avail = nq - gaps

    def floor2(x):
        return 1 << (max(1, x).bit_length() - 1)
    ub = floor2(min(avail // vf, max_ic))
    lb = floor2(min(avail // (2 * vf), max_ic))
    ic = ub if ub != lb and avail % (vf * ub) == avail % (vf * lb) else lb
    n = avail // (vf * ic) * vf * ic
    evf = n_epi = 0
    rem = nq % (vf * ic)                      # LLVM's remainder, gaps aside
    if vf * ic >= 16 and rem >= 2:
        evf = _pick_vf(rem, costs, [e for e in (2, 4, 8) if e <= min(vf, rem)])
        n_epi = (nq - n - gaps) // evf * evf
    return vf, ic, n, evf, n_epi


# XLA's CPU fusion pass fuses a vector-matrix dot with the producer of its
# matrix only while the vector is smaller than this (kFusionThresholdBytes)
_DOT_FUSION_BYTES = 16 * 1024


def _gemv_order(scorer: str, nq: int, m: int) -> Tuple[_Part, ...]:
    """The sum order of the unfused dot, where the float32 q_w reaches
    `_DOT_FUSION_BYTES` (nq >= 4,096): a loop fusion writes new_q, then XLA
    emits the dot as its tiled column-major GEMV, 8 candidates a vector and
    8 queries a tile.  Each candidate's total is one float32 FMA chain over
    the queries in order, from the first product.  The first tile selects
    the product at query 0; where one candidate is left over from the
    vectors (m % 8 == 1), its scalar loop keeps that select, and so its
    multiply apart from the add: the tile's products are rounded before
    they are added (more leftover candidates make a loop that LLVM
    unswitches, and the select goes).  The loop fusion computes the RID
    term as straight code: the replace scorer's CPU_ROW * ridr is hoisted
    out of the candidate loop where there is one (form "A"), the secondary
    scorer's is not ("B")."""
    form = "A" if scorer == "rep" and m > 1 else "B"
    if m % 8 != 1:
        return (_Part(1, 1, nq, False, form),)
    return (_Part(1, 1, 8, False, form, False),
            _Part(1, 1, nq - 8, False, form))


def _xla_sum_order(scorer: str, nq: int, m: int, ns: int
                   ) -> Tuple[_Part, ...]:
    """How XLA's CPU code (x86, AVX-512, 8-wide float32 vectors) sums a
    scorer's `q_w @ new_q`: consecutive `_Part`s, the first from 0, each
    continuing from the total before it (`_xla_dot`).  From 4,096 queries
    on, the dot is not fused (`_gemv_order`); below, as follows.

    Read off XLA's dumps (`XLA_FLAGS=--xla_dump_to`, `*.ir-with-opt.ll` and
    the object code; jax 0.9.0 on x86 with AVX-512F) of the JAX package's
    `_jax_score_secondary` / `_jax_score_replace` (scorer "sec" / "rep", m
    candidates, ns kept secondaries) at nq 1-200 and up to 4,095, m 1-9,
    16, 40, ns 1-24.  XLA emits the dot as a column loop over the m
    candidates around a query loop, and LLVM vectorizes the query loop as
    its loop vectorizer does for a known trip count (`_vector_plan`, with
    the class costs of `_loop_class`): a main loop of VF lanes and IC
    interleaved accumulators, a vector epilogue of fewer lanes when VF x IC
    >= 16, then the scalar remainder.  Below 16 queries the loop is a
    chain, except where LLVM unrolled it first and vectorized across the
    candidates (a chain too), m = 1 at 14 and 15 queries (one 8-lane vector
    with its tail masked) and the replace scorer's loops of 4 and 8 (one
    vector).  The replace scorer's loop is not vectorized at ns >= 18 (read
    at nq 1-100, m 1-40, ns 18-64, and up to 4,095 at ns 18-32).

    The RID term's form: the secondary scorer's is "B" (its ridr differs
    per candidate).  The replace scorer's CPU_ROW * ridr is the same for
    every candidate, so where the query loop's code is straight (an
    unrolled loop or remainder) inside a column loop that LLVM keeps, it is
    hoisted out of that loop and form "A" follows; elsewhere "B".  LLVM
    keeps the column loop at m > 8 and at m (ns + 1) > 16 (below 18 kept
    secondaries; at 18 and more, see the code).

    Left open (ROADMAP Queue C): the replace scorer where XLA unrolls both
    loops into scalar code (m >= 2 and m nq (11 + 13 ns) <= 432), at 9-17
    kept secondaries, past 32 kept secondaries from 22 queries on, and at
    m 2..8 beyond ~300 queries, where LLVM keeps or partly unrolls the
    column loop at sizes not modelled here."""
    if 4 * nq >= _DOT_FUSION_BYTES:
        return _gemv_order(scorer, nq, m)
    wide = m > 8
    kept = m > 1 and (wide or m * (ns + 1) > 16)

    def form(straight: bool) -> str:
        return "A" if scorer == "rep" and kept and straight else "B"

    def chain(f: str) -> Tuple[_Part, ...]:
        return (_Part(1, 1, nq, False, f),)
    if scorer == "rep" and (nq * (11 + 13 * ns) <= 300
                            or (m == 2 and ns == 1 and nq == 13)):
        # unrolled before vectorization, then vectorized across the
        # candidates.  (13, 2, 1), 312 units, is the one shape seen unrolled
        # past the budget, and (4, 2, 5), 304, stays rolled: no budget for
        # m = 2 holds both, and a size a query of its own (8 + 14 ns holds
        # both) unrolls (1, 2, 21) and (1, 2, 22), which the totals there
        # rule out
        return chain("B" if m == 1 else "A")
    if scorer == "rep" and ns >= 18:
        # the kept secondaries' loop stays a loop, so the query loop is not
        # vectorized: a chain.  Up to 32 kept secondaries LLVM unrolls the
        # query loop up to 9 queries and keeps the candidate loop around it
        # where m (nq + 1) > 12, and hoists CPU_ROW * ridr out of it (at
        # one query XLA multiplies instead of a dot, and hoists it too);
        # past 32 it hoists it at every query count up to 21
        hoisted = nq == 1 or ns > 32 or (nq <= 9 and m * (nq + 1) > 12)
        return chain("A" if m > 1 and hoisted else "B")
    if nq < 16:
        if m == 1 and ns <= 1 and nq >= 14:
            return (_Part(8, 1, nq, True, "B"),)
        if scorer == "rep" and nq in (4, 8):
            return (_Part(nq, 1, nq, True,
                          "A" if kept and 2 <= ns <= 8 else "B"),)
        return chain("B")
    costs, max_ic, unroll, unroll_epi = _loop_class(scorer, m, ns)
    vf, ic, n, evf, n_epi = _vector_plan(nq, costs, int(2 <= m <= 8), max_ic)
    if vf * ic >= 16 and nq % (vf * ic) >= 2:
        unroll = unroll_epi
    unrolled = n // vf <= unroll
    parts = [_Part(vf, ic, n, unrolled, form(unrolled))]
    if n_epi:
        parts.append(_Part(evf, 1, n_epi, True, form(ns <= 8)))
    rest = nq - n - n_epi
    if rest:
        # LLVM unrolls a scalar remainder of up to 18 // ns queries (9 at
        # ns <= 2)
        parts.append(_Part(1, 1, rest, False,
                           form(rest <= 18 // max(ns, 2))))
    return tuple(parts)


def _sec_edge_form(nq: int, m: int) -> Optional[str]:
    """The secondary scorer's ninth candidate column at m = 9, in scalar
    code past the 8-wide vector across the candidates: form A at nq = 2, 5
    and 7 (read off the dumps as `_xla_sum_order`), else the other columns'
    form (None)."""
    return "A" if m == 9 and nq in (2, 5, 7) else None


def _xla_dot(q_w: torch.Tensor, new_q: torch.Tensor,
             order: Sequence[_Part]) -> torch.Tensor:
    """`q_w @ new_q` (nq,) x (nq, m) -> (m,) float32 in `order`.

    A vector part: query t*lanes*accs + j*lanes + l goes to lane l of
    accumulator j by FMA (the total so far starts lane 0 of accumulator 0),
    the accumulators are added in order and the lanes summed as a halving
    tree (8 lanes: ((l0+l4)+(l2+l6)) + ((l1+l5)+(l3+l7))).  In one
    iteration, or in a fully unrolled loop, LLVM's DAG combiner folds each
    accumulator into that sum instead: one FMA chain a lane, accumulator 0
    in iteration order, then each next one in the order 1, 0, 2, 3, ...  A
    part shorter than its vector masks its tail (products of 0).  A chain
    part continues the total by FMA, query by query; a chain that is not
    fused starts the last candidate's total with rounded products."""
    total = None
    b = 0
    for lanes, accs, n, unrolled, _, fused in order:
        w, x = q_w[b:b + n], new_q[b:b + n]
        b += n
        if lanes == 1 and fused:
            total = _fma_chain(w, x, init=total)
            continue
        if lanes == 1:                  # the GEMV's one leftover candidate
            total = torch.cat([_fma_chain(w, x[:, :-1]),
                               _mul_add_chain(w, x[:, -1:])])
            continue
        pad = -n % (lanes * accs)
        if pad:
            w = torch.cat([w, w.new_zeros(pad)])
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        its = (n + pad) // (lanes * accs)
        w = w.reshape(its, accs, lanes)
        x = x.reshape(its, accs, lanes, new_q.shape[1])
        init = torch.zeros(x.shape[2:], dtype=torch.float32, device=x.device)
        if total is not None:
            init[0] = total
        if its == 1:
            acc = _fma_chain(w[0], x[0], init=init)
        else:
            acc = _fma_chain(w[:, 0], x[:, 0], init=init)
            if accs > 1 and unrolled:
                t = [1, 0] + list(range(2, its))
                acc = _fma_chain(w[t, 1:].transpose(0, 1).reshape(-1, lanes),
                                 x[t, 1:].transpose(0, 1).reshape(
                                     -1, lanes, new_q.shape[1]), init=acc)
            elif accs > 1:
                for part in _fma_chain(w[:, 1:], x[:, 1:]).unbind(0):
                    acc = part + acc
        while acc.shape[0] > 1:                     # the halving tree
            h = acc.shape[0] // 2
            acc = acc[:h] + acc[h:]
        total = acc[0]
    return total


def _by_form(order: Sequence[_Part], f) -> torch.Tensor:
    """new_q rows from `f(form)`, each part's rows in its own form."""
    forms = {p.form for p in order}
    if len(forms) == 1:
        return f(forms.pop())
    rows = {form: f(form) for form in forms}
    out, b = [], 0
    for p in order:
        out.append(rows[p.form][b:b + p.n])
        b += p.n
    return torch.cat(out)


def _score_secondary_torch(cur_q, cov, seek, ridr, size_c, beta_c,
                           ncols_used, q_w):
    """New weighted query totals when each candidate secondary is added."""
    npages = _pages_f32(size_c)
    order = _xla_sum_order("sec", cov.shape[0], cov.shape[1], 0)

    def new_q(form):
        rid = _rid_f32(ridr, npages, beta_c, ncols_used[:, None], form)
        return torch.minimum(cur_q[:, None], torch.minimum(cov, seek + rid))
    x = _by_form(order, new_q)
    edge = _sec_edge_form(cov.shape[0], cov.shape[1])
    if edge is not None:
        x = torch.cat([x[:, :8], new_q(edge)[:, 8:]], dim=1)
    return _xla_dot(q_w, x, order)


def _score_replace_torch(scanc_c, cov, seek, ridr, size_c, beta_c,
                         ncols_used, q_w):
    """Clustered-replacement scoring: every kept secondary path under every
    candidate clustered layout.  scanc_c (nq, m) candidate scan costs;
    cov/seek/ridr (nq, ns) the kept-secondary rows; size_c/beta_c (m,)
    the candidate layouts' RID coupling."""
    npages = _pages_f32(size_c)                                   # (m,)
    r3 = ridr[:, :, None]
    order = _xla_sum_order("rep", scanc_c.shape[0], scanc_c.shape[1],
                           cov.shape[1])

    def new_q(form):
        rid = _rid_f32(r3, npages, beta_c, ncols_used[:, None, None], form)
        path = torch.minimum(cov[:, :, None], seek[:, :, None] + rid)
        return torch.minimum(scanc_c, path.amin(dim=1))
    return _xla_dot(q_w, _by_form(order, new_q), order)


def _own_path_torch(cov, seek, ridr, size_c, beta_c, ncq, is_sec):
    """A candidate's own path under the current clustered layout: its
    covering or seek + RID cost where it is secondary, inf where it is
    clustered.  Elementwise over broadcast shapes: (m,) candidates with
    scalar layout terms per job, or (J, m) with (J, 1) across jobs, so
    per-job and stacked costing share one float32 op sequence."""
    npag = _pages_f32(size_c)
    rid = (cm.T_IO_RAND * torch.minimum(ridr, npag)
           + cm.CPU_ROW * ridr + beta_c * ridr * ncq)
    return torch.where(is_sec != 0, torch.minimum(cov, seek + rid),
                       torch.full_like(cov, _INF))


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
    own = _own_path_torch(cov_k, seek_k, ridr_k, size_c, beta_c, ncq,
                          is_sec)
    return torch.minimum(torch.minimum(scan_l, base_path), own)


def _cand_costs_stacked_torch(scan_l, cov, seek, ridr, size_c, beta_c, ncq,
                              is_sec):
    """Cross-job stacked twin of `_cand_costs_torch` for secondary-free
    bases: (J, m) candidate rows, (J, 1) per-job layout terms.  The own
    path comes from the same `_own_path_torch`; the minimum with the
    empty base path (inf) is left out, which is exact for every value of
    scan_l."""
    return torch.minimum(scan_l, _own_path_torch(cov, seek, ridr, size_c,
                                                 beta_c, ncq, is_sec))


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
        self.rows_added = 0       # statement rows appended incrementally
        self.rows_removed = 0     # statement rows dropped incrementally
        self.cols_refreshed = 0   # columns refilled after size changes

    def stats(self) -> Dict[str, int]:
        return {"rows_added": self.rows_added,
                "rows_removed": self.rows_removed,
                "cols_refreshed": self.cols_refreshed}

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

    # -- incremental maintenance (online sessions) -----------------------
    def apply_delta(self, delta) -> None:
        """Apply a `workload.WorkloadDelta`: removed statements' rows are
        dropped, reweights touch only the weight vectors, and each added
        statement appends one fully-evaluated row per registered access
        path; no existing matrix entry is recomputed."""
        removed = set(delta.removed)
        if removed:
            for blk in self.blocks.values():
                self.rows_removed += blk.remove_statements(removed)
        for name, w in delta.reweighted:
            if not any(blk.reweight(name, float(w))
                       for blk in self.blocks.values()):
                raise KeyError(f"cannot reweight unknown statement {name!r}")
        by_table: Dict[str, list] = {}
        for s in delta.added:
            by_table.setdefault(s.table, []).append(s)
        for table, stmts in by_table.items():
            self.blocks[table].add_statements(stmts)
            self.rows_added += len(stmts)

    def sync_sizes(self) -> int:
        """Refill columns whose registered size changed since they were
        computed; returns the number of refreshed columns."""
        refreshed = 0
        for blk in self.blocks.values():
            refreshed += blk.refresh_sizes(self.sizes)
        self.cols_refreshed += refreshed
        return refreshed

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

    def config_costs(self, configs: Sequence[Configuration]) -> np.ndarray:
        """`config_cost` of each configuration, as a float64 array."""
        return np.array([self.config_cost(c) for c in configs])

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

    def cost_job_arrays(self, query: Query, base: Configuration,
                        cands: Sequence[IndexDef]) -> Dict[str, object]:
        """Gather one (query, base, candidates) costing job as flat
        per-candidate arrays for cross-job stacking (the fleet's cost
        phase).  Requires a secondary-free `base` (the advisor's
        `base_configuration`), which makes the job purely elementwise;
        `batched_candidate_costs` then scores many jobs at once with
        exactly the per-job `candidate_query_costs` arithmetic."""
        table = query.table
        blk = self.blocks[table]
        self.register(cands)
        c_id, sec_ids = self.split(base, table)
        if sec_ids:
            raise ValueError("cost_job_arrays requires a secondary-free "
                             "base configuration")
        qi = blk.query_row(query)
        ids = np.array([blk.id_of(i) for i in cands], dtype=np.int64)
        is_sec = np.array([not i.clustered for i in cands])
        cl_ids = np.where(is_sec, c_id, ids)  # layout each k runs under
        return {
            "scan_l": blk.scanc[qi, cl_ids], "cov": blk.cov[qi, ids],
            "seek": blk.seek[qi, ids], "ridr": blk.ridr[qi, ids],
            "size_c": float(blk.size[c_id]),
            "beta_c": float(blk.beta[c_id]),
            "ncq": float(blk.ncols_used[qi]), "is_sec": is_sec,
        }

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


# ---------------------------------------------------------------------------
# Streamed costing for workloads too large to hold as dense matrices
# ---------------------------------------------------------------------------

def chunked_config_costs(workload: Workload, sizes: SizeProvider,
                         configs: Sequence[Configuration],
                         chunk_statements: int = 8192,
                         device: Optional[torch.device] = None
                         ) -> np.ndarray:
    """Full-workload cost of each configuration, streamed in statement
    chunks.

    Never materializes the full (statements x access-path) matrices: each
    chunk builds a short-lived engine over at most `chunk_statements`
    statements (on `device`), scores every configuration against it, and
    accumulates the weighted totals — peak memory is O(chunk x registered
    paths) however large the workload.  The summation ORDER differs from a
    monolithic `CostEngine.config_cost` (per-chunk partial sums), so this
    is the memory-bounded evaluation path for huge workloads, not a
    bit-parity replacement for the in-core engine; the chunks and their
    sums run in the JAX package's order.
    """
    configs = list(configs)
    totals = np.zeros(len(configs))
    stmts = workload.statements
    if not stmts or not configs:
        return totals
    for lo in range(0, len(stmts), int(chunk_statements)):
        sub = Workload(schema=workload.schema,
                       statements=stmts[lo:lo + int(chunk_statements)])
        eng = CostEngine(sub, sizes, device=device)
        for k, cfg in enumerate(configs):
            totals[k] += eng.config_cost(cfg)
    return totals


# ---------------------------------------------------------------------------
# Cross-tenant stacked candidate costing (the fleet's cost phase)
# ---------------------------------------------------------------------------

def batched_candidate_costs(jobs: Sequence[Dict[str, object]],
                            device: Optional[torch.device] = None
                            ) -> np.ndarray:
    """Score many `CostEngine.cost_job_arrays` jobs in one stacked
    (job x candidate) pass.

    Per element this is exactly the `candidate_query_costs` arithmetic for
    a secondary-free base: with no device the same float64 NumPy ufunc
    sequence, with a torch device the float32 op sequence of
    `_cand_costs_torch` (`_cand_costs_stacked_torch`, the stacked arrays
    copied to the device in one transfer and the result read back in
    one).  So a job scored in a fleet batch equals the per-job call
    bitwise.  Returns a (len(jobs), max_m) float64 array; row i's first
    len(jobs[i]["cov"]) entries are live, the pad tail is meaningless.
    """
    J = len(jobs)
    m = max((len(j["cov"]) for j in jobs), default=0)
    if not J or not m:
        return np.zeros((J, m))

    def stack(key, fill):
        out = np.full((J, m), fill)
        for i, j in enumerate(jobs):
            out[i, :len(j[key])] = j[key]
        return out

    scan_l = stack("scan_l", 0.0)
    cov = stack("cov", np.inf)
    seek = stack("seek", np.inf)
    ridr = stack("ridr", 0.0)
    is_sec = stack("is_sec", False)
    size_c = np.array([j["size_c"] for j in jobs])[:, None]
    beta_c = np.array([j["beta_c"] for j in jobs])[:, None]
    ncq = np.array([j["ncq"] for j in jobs])[:, None]
    if device is not None:
        return _host(_cand_costs_stacked_torch(*to_device(
            [scan_l, cov, seek, ridr, size_c, beta_c, ncq, is_sec],
            np.float32, device)))
    rid = cm.rid_lookup_cost(ridr, size_c, ncols_used=ncq,
                             beta_coef=beta_c)
    own = np.where(is_sec, np.minimum(cov, seek + rid), np.inf)
    return np.minimum(scan_l, own)
