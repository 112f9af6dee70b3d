"""Batched §5.2 deduction planner: the greedy graph search as array code.

The engine runs the greedy for **all sampling fractions in one pass over a
shared deduction graph**:

* **Graph build (f-independent, built once).**  The node universe and each
  target's candidate-deduction set do not depend on f: ColSet mates can only
  be targets, never nodes materialized mid-walk — a materialized child is strictly narrower than its
  creator, and the walk is narrow-to-wide, so it can never share a column
  set with a later target.  The build records, per target in processing
  order, the candidate `Deduction`s with their children packed into
  (ncand, K) id arrays (EXACT-padded), plus the deduction-error term of
  each candidate.

* **Per-(node, f) state arrays.**  Node state / error-RV mean / error-RV
  std live in (nnodes, nf) arrays.  One pass over the targets then scores
  lines 6-9 of the §5.2 pseudocode for a target's whole candidate set, for
  every f, at once.

* **(node × f) sampling-cost matrix.**  §5.1 sampling costs are pure in
  table stats, so the lines 8-9 "enable by sampling unknown children"
  comparison is an argmin over `extra = Σ cost(unknown child)` arrays.

Scoring backends.  With no device (the numpy backend) the greedy runs on
the host, a record at a time: its Goodman fold and probabilities are
float64 NumPy — `errors.goodman_fold` and the exact-erf
`errors.prob_within_batch` — plan-identical to the JAX package's numpy
backend.  With a torch device the engine packs the graph once
(`_pack`) and the whole greedy runs in one `planner_walk` call
(`repro_torch.kernels.planner_score`): one launch per plan on the card,
its plain version on the CPU.  Records read states that earlier records
wrote, but every read and write is per (node, f), so the walk runs the
fractions side by side.  It scores each record as the JAX package's jax
backend does (the `fused_score` fold and float32 probability) and picks
winners and accumulates costs in float64 as the host does.  The same
launch judges each fraction's feasibility from the targets' final RVs,
rounded to float32 and scored by the same float32 probability, so a plan
costs one launch.

Not ported yet: the cross-run replay of recorded decisions, node-universe
epoch eviction and fault injection, which serve the online session.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import planner_score as _ps
from . import errors as err
from .backend import to_device
from .compression import METHODS
from .estimation_graph import (Deduction, F_GRID, Node, NodeKey, Plan, State,
                               FORCE_ALL_Q, _colext_deductions, _colset_ded,
                               memoized_sampling_cost)

# state codes (match estimation_graph.State member order and the walk's)
_NONE, _DEDUCED, _SAMPLED, _EXACT = _ps.NONE, _ps.DEDUCED, _ps.SAMPLED, \
    _ps.EXACT
_STATE_OF = {_DEDUCED: State.DEDUCED, _SAMPLED: State.SAMPLED}


def _kind_code(method: str) -> int:
    return 1 if METHODS[method].order_dependent else 0


@dataclasses.dataclass
class _TargetRec:
    """One target's candidate-deduction set, packed for array scoring.

    Every candidate child shares the target's compression method (ColSet
    mates by definition, ColExt parts by construction), so one order-class
    code covers the whole record.

    Candidates are packed in TWO blocks, in candidate order (ColSet mates
    first, then ColExt partitions): ColSet candidates all have exactly one
    child, so they score as (ncs, nf) arrays with no K axis.  Folding a
    single factor equals folding it with EXACT padding (multiplying by
    exact 1.0 is the identity), so the split is bit-identical to one
    padded block.
    """
    tid: int
    key: NodeKey
    kind: int                # order-class code of target AND all children
    cands: Tuple[Deduction, ...]
    ncs: int                 # leading single-child (ColSet) candidates
    cs_ids: np.ndarray       # (ncs,) ColSet child node ids
    cx_ids: np.ndarray       # (ncx, K) ColExt child ids, -1-padded
    nchild: List[int]        # real (unpadded) child count per candidate
    cx_dm: np.ndarray        # (ncx, 1) ColExt deduction-error term (T. 3)
    cx_msq: np.ndarray       # (ncx, 1) ... mean^2    (Goodman E^2 factor)
    cx_vterm: np.ndarray     # (ncx, 1) ... std^2 + mean^2     (V factor)

    def child_row(self, w: int) -> np.ndarray:
        """Child-id row of candidate `w` in candidate order."""
        if w < self.ncs:
            return self.cs_ids[w:w + 1]
        return self.cx_ids[w - self.ncs]


@dataclasses.dataclass
class _Graph:
    """The node universe (`node_keys` / `node_id`, ids in insertion
    order) and the targets' records in processing order."""
    node_keys: List[NodeKey]
    node_id: Dict[NodeKey, int]
    recs: List[_TargetRec]


@dataclasses.dataclass
class _RunState:
    """Resolved per-(node, f) arrays of one `_run` pass, pre-assembly."""
    g: _Graph
    targets: Tuple[NodeKey, ...]
    f_grid: Tuple[float, ...]
    state: np.ndarray             # (nnodes+1, nf) state codes
    mean: np.ndarray              # (nnodes+1, nf) rv mean
    std: np.ndarray               # (nnodes+1, nf) rv std
    used: np.ndarray              # (nnodes+1, nf) used-as-child flags
    chosen: Dict[Tuple[int, int], Deduction]
    total: List[float]            # per-f accumulated sampling cost
    feasible: Optional[np.ndarray] = None   # (nf,) judged by the walk


class PlannerEngine:
    """Runs the §5.2 greedy for a whole f grid over one shared graph."""

    def __init__(self, tables: Dict, device: Optional[torch.device] = None):
        self.device = device
        self.tables = tables
        self._scost: Dict[Tuple[str, Tuple[str, ...], float], float] = {}
        self._pcache: Dict[Tuple[float, float, float], float] = {}
        self._node_keys: List[NodeKey] = []
        self._node_id: Dict[NodeKey, int] = {}
        rv = err.colset_error()
        self._cs_fac = (rv.mean, rv.mean * rv.mean,
                        rv.std * rv.std + rv.mean * rv.mean)

    # ------------------------------------------------------------------
    # Graph construction (f-independent)
    # ------------------------------------------------------------------
    def _add_node(self, k: NodeKey) -> int:
        nid = self._node_id.get(k)
        if nid is None:
            nid = self._node_id[k] = len(self._node_keys)
            self._node_keys.append(k)
        return nid

    def _colext_block(self, t: NodeKey) -> tuple:
        """Packed ColExt candidates of `t`.  Pad id is -1: it always
        indexes the LAST buf row, which every `_run` allocates as the
        virtual EXACT node (neutral under compose, zero cost)."""
        cands = _colext_deductions(t)
        for d in cands:
            for c in d.children:
                self._add_node(c)
        ncx = len(cands)
        nchild = [len(d.children) for d in cands]
        kmax = max(nchild, default=1)
        cx_ids = np.full((ncx, kmax), -1, dtype=np.int64)
        dm = np.empty((ncx, 1))
        ds = np.empty((ncx, 1))
        for i, d in enumerate(cands):
            row = cx_ids[i]
            for j, c in enumerate(d.children):
                row[j] = self._node_id[c]
            drv = err.colext_error(t.method, nchild[i])
            dm[i, 0] = drv.mean
            ds[i, 0] = drv.std
        msq = dm * dm
        return cands, cx_ids, nchild, dm, msq, ds * ds + msq

    def _build_rec(self, t: NodeKey, group: Optional[tuple]) -> _TargetRec:
        cx_cands, cx_ids, cx_nchild, cx_dm, cx_msq, cx_vt = \
            self._colext_block(t)
        if group is None:
            cs_cands: List[Deduction] = []
            cs_ids = np.empty(0, dtype=np.int64)
        else:
            ids, pos_map, ded_list = group
            pos = pos_map[t]
            cs_cands = ded_list[:pos] + ded_list[pos + 1:]
            cs_ids = np.delete(ids, pos)
        cands = tuple(cs_cands) + tuple(cx_cands)
        nchild = [1] * len(cs_cands) + list(cx_nchild)
        return _TargetRec(self._node_id[t], t, _kind_code(t.method), cands,
                          len(cs_cands), cs_ids, cx_ids, nchild,
                          cx_dm, cx_msq, cx_vt)

    def _build_graph(self, targets: Sequence[NodeKey]) -> _Graph:
        # ColSet mate groups: (table, column set, method) -> members in
        # first-seen target order
        by_set: Dict[Tuple[str, frozenset, str], List[NodeKey]] = {}
        seen = set()
        for t in targets:
            self._add_node(t)
            if t not in seen:
                seen.add(t)
                by_set.setdefault(t.gkey(), []).append(t)
        groups = {}
        for gk, members in by_set.items():
            ids = np.array([self._node_id[m] for m in members],
                           dtype=np.int64)
            groups[gk] = (ids, {m: i for i, m in enumerate(members)},
                          [_colset_ded(o) for o in members])

        recs: List[_TargetRec] = []
        built: Dict[NodeKey, _TargetRec] = {}
        for t in sorted(targets, key=lambda k: (len(k.cols), k.cols)):
            rec = built.get(t)
            if rec is None:
                group = (None if METHODS[t.method].order_dependent
                         else groups[t.gkey()])
                rec = built[t] = self._build_rec(t, group)
            recs.append(rec)
        return _Graph(self._node_keys, self._node_id, recs)

    def _sampling_cost(self, key: NodeKey, f: float) -> float:
        return memoized_sampling_cost(self.tables, self._scost, key, f)

    # ------------------------------------------------------------------
    # Scoring backend (probability + fused candidate scoring)
    # ------------------------------------------------------------------
    def _prob_cached(self, means: np.ndarray, stds: np.ndarray,
                     e: float) -> np.ndarray:
        """The host's float64 probabilities behind a (e, mean, std) memo:
        composed RVs recur heavily across candidates, targets and
        fractions.  Cache values are exactly
        the batch-computed floats, so parity is unaffected.  Large requests
        are deduplicated first (packing the exact float pair into a complex
        for one `np.unique`)."""
        pc = self._pcache
        if means.size > 64:
            u, inv = np.unique(means + stds * 1j, return_inverse=True)
            um = u.real
            us = u.imag
        else:
            inv = None
            um, us = means, stds
        ml = um.tolist()
        sl = us.tolist()
        out = [0.0] * len(ml)
        miss: List[int] = []
        for i, a in enumerate(ml):
            v = pc.get((e, a, sl[i]))
            if v is None:
                miss.append(i)
            else:
                out[i] = v
        if miss:
            got = err.prob_within_batch(np.array([ml[i] for i in miss]),
                                        np.array([sl[i] for i in miss]),
                                        e).tolist()
            for i, v in zip(miss, got):
                out[i] = v
                pc[(e, ml[i], sl[i])] = v
        res = np.array(out)
        return res[inv] if inv is not None else res

    # ------------------------------------------------------------------
    # The batched greedy (paper §5.2, all fractions at once)
    # ------------------------------------------------------------------
    def _scost_matrix(self, g: _Graph, f_grid: Tuple[float, ...]
                      ) -> np.ndarray:
        """(node x f) §5.1 sampling costs of the universe's nodes."""
        out = np.zeros((len(g.node_keys), len(f_grid)))
        for nid, k in enumerate(g.node_keys):
            for fi, f in enumerate(f_grid):
                out[nid, fi] = self._sampling_cost(k, f)
        return out

    def plan_batch(self, targets: Sequence[NodeKey], e: float,
                   q: float) -> Plan:
        """§5.2 outer loop: cheapest feasible plan over the f grid (else
        the cheapest overall), materializing only the winner."""
        st = self._run(targets, e, q)
        feas = self._feasible_vec(st, e, q)
        best_fi: Optional[int] = None
        fb_fi = 0
        for fi in range(len(st.f_grid)):
            if feas[fi] and (best_fi is None
                             or st.total[fi] < st.total[best_fi]):
                best_fi = fi
            if st.total[fi] < st.total[fb_fi]:
                fb_fi = fi
        fi = best_fi if best_fi is not None else fb_fi
        return self._assemble_one(st, fi, bool(feas[fi]))

    def plan_all_sampled_batch(self, targets: Sequence[NodeKey], e: float,
                               q: float) -> Plan:
        """The "All" baseline: greedy under FORCE_ALL_Q (every deduction
        fails, so everything samples), feasibility re-judged against the
        caller's q; first feasible fraction wins, else the cheapest."""
        st = self._run(targets, e, FORCE_ALL_Q, q_feas=q)
        feas = self._feasible_vec(st, e, q)
        fb_fi = 0
        for fi in range(len(st.f_grid)):
            if feas[fi]:
                return self._assemble_one(st, fi, True)
            if st.total[fi] < st.total[fb_fi]:
                fb_fi = fi
        return self._assemble_one(st, fb_fi, False)

    @staticmethod
    def _concat(a: Optional[np.ndarray],
                b: Optional[np.ndarray]) -> np.ndarray:
        if a is None:
            return b
        if b is None:
            return a
        return np.concatenate([a, b], axis=0)

    def _run(self, targets: Sequence[NodeKey], e: float, q: float,
             q_feas: Optional[float] = None) -> "_RunState":
        """One pass over the targets, scoring lines 6-9 of the §5.2
        pseudocode for the whole candidate set, for every f, at once.
        On a torch device the walk also judges feasibility against
        q_feas (q by default).

        One composed-RV evaluation serves BOTH phases: with unknown
        children substituted by their hypothetical SampleCF error, the
        trial RV of lines 8-9 equals the actual deduction RV of lines 6-7
        on fully-known rows (the where() substitutes nothing there), so
        the two phases share one `compose`-equivalent and one
        mask-compressed probability call.
        """
        f_grid = F_GRID
        g = self._build_graph(targets)
        nf = len(f_grid)
        n = len(g.node_keys)
        pad = n   # child_ids pad id -1 wraps to this last row

        # packed per-(node, f) state: [state code, rv mean, rv std, cost]
        # — one fancy-index gathers everything a candidate row needs
        buf = np.zeros((n + 1, 4, nf))
        buf[:, 1, :] = 1.0                        # default rv = EXACT
        buf[pad, 0, :] = _EXACT
        buf[:n, 3, :] = self._scost_matrix(g, f_grid)
        state = buf[:, 0, :]
        scost = buf[:, 3, :]

        # SampleCF error RVs per (order class, f) — Table 2 fits
        samp = np.empty((2, 2, nf))               # [kind, mean/std, f]
        rep = {_kind_code(m): m for m in METHODS}
        for kc, method in rep.items():
            for fi, f in enumerate(f_grid):
                rv = err.samplecf_error(method, f)
                samp[kc, 0, fi] = rv.mean
                samp[kc, 1, fi] = rv.std
        samp_mean = samp[:, 0, :]
        samp_std = samp[:, 1, :]
        if self.device is not None:
            return self._walk(g, targets, f_grid, scost, samp_mean,
                              samp_std, e, q,
                              q if q_feas is None else q_feas)

        total = [0.0] * nf
        used = np.zeros((n + 1, nf), dtype=bool)
        chosen: Dict[Tuple[int, int], Deduction] = {}
        false_f = np.zeros(nf, dtype=bool)

        for rec in g.recs:
            tid = rec.tid
            act = state[tid] == _NONE              # (nf,)
            nc = len(rec.cands) if act.any() else 0
            kc = rec.kind
            has6 = has9 = false_f
            if nc:
                chs = buf[rec.cs_ids] if rec.ncs else None
                chx = buf[rec.cx_ids] if nc > rec.ncs else None
                # per-block Goodman accumulators, concatenated in candidate
                # order (ColSet first): a single-child fold equals the
                # padded fold (the EXACT pads multiply by exact 1.0), so
                # the block split is bit-identical to one padded block
                known_s = chs[:, 0, :] != _NONE if chs is not None else None
                if chx is not None:
                    known_x = chx[:, :, 0, :] != _NONE
                    allk_x = known_x.all(axis=1)   # (ncx, nf)
                else:
                    allk_x = None
                allk = self._concat(known_s, allk_x)   # (nc, nf)
                any_unknown = not allk.all()
                cs_dm, cs_msq, cs_vt = self._cs_fac
                m_s = s_s = m_x = s_x = None
                if chs is not None:
                    m_s = chs[:, 1, :]
                    s_s = chs[:, 2, :]
                    if any_unknown:
                        # children RVs, unknown ones hypothetically sampled
                        # (all children share the target's method, hence
                        # one Table 2 error fit per record)
                        m_s = np.where(known_s, m_s, samp_mean[kc])
                        s_s = np.where(known_s, s_s, samp_std[kc])
                if chx is not None:
                    m_x = chx[:, :, 1, :]
                    s_x = chx[:, :, 2, :]
                    if any_unknown:
                        m_x = np.where(known_x, m_x, samp_mean[kc])
                        s_x = np.where(known_x, s_x, samp_std[kc])
                cmA = vA = e2A = None
                if chs is not None:
                    msq_s = m_s * m_s
                    cmA = m_s * cs_dm
                    vA = (s_s * s_s + msq_s) * cs_vt
                    e2A = msq_s * cs_msq
                cmB = vB = e2B = None
                if chx is not None:
                    # Goodman fold over the children axis, continued with
                    # the deduction-error factor — bit-identical to the
                    # scalar compose (children in order, deduction last)
                    cmB, vB, e2B = err.goodman_fold(m_x, s_x, axis=1)
                    cmB = cmB * rec.cx_dm
                    vB = vB * rec.cx_vterm
                    e2B = e2B * rec.cx_msq
                cm = self._concat(cmA, cmB)
                v = self._concat(vA, vB)
                e2 = self._concat(e2A, e2B)
                cs = np.sqrt(np.maximum(v - e2, 0.0))

                mask67 = allk & act
                if any_unknown:
                    # lines 8-9 precondition: summed sampling cost of the
                    # unknown children.  add.reduce over a non-contiguous
                    # axis is a sequential fold, and the known children's
                    # exact 0.0 terms leave every partial sum unchanged —
                    # so this matches the scalar child-order sum
                    # bit-for-bit.
                    extraA = None if chs is None else \
                        np.where(known_s, 0.0, chs[:, 3, :])
                    extraB = None if chx is None else np.add.reduce(
                        np.where(known_x, 0.0, chx[:, :, 3, :]), axis=1)
                    extra = self._concat(extraA, extraB)
                    my_cost = scost[tid]           # (nf,)
                    pre9 = ~allk & (extra < my_cost) & act
                    mask_p = mask67 | pre9
                else:
                    pre9 = None
                    mask_p = mask67

                # one probability pass over both phases' eligible entries
                p = np.zeros((nc, nf))
                ii = mask_p.nonzero()
                if ii[0].size:
                    p[ii] = self._prob_cached(cm[ii], cs[ii], e)
                sat = p >= q

                # ---- lines 6-7: an enabled deduction satisfying (e, q) --
                elig = mask67 & sat
                has6 = elig.any(axis=0)
                if has6.any():
                    w6 = np.argmax(np.where(elig, p, -1.0), axis=0)
                    for fi_ in np.nonzero(has6)[0]:
                        fi = int(fi_)
                        w = int(w6[fi])
                        buf[tid, :3, fi] = _DEDUCED, cm[w, fi], cs[w, fi]
                        chosen[(tid, fi)] = rec.cands[w]
                        used[rec.child_row(w), fi] = True

                # ---- lines 8-9: enable one by sampling unknown children -
                has9 = false_f
                if pre9 is not None:
                    ok9 = pre9 & sat & ~has6
                    has9 = ok9.any(axis=0)
                if has9.any():
                    w9 = np.argmin(np.where(ok9, extra, np.inf), axis=0)
                    for fi_ in np.nonzero(has9)[0]:
                        fi = int(fi_)
                        w = int(w9[fi])
                        for cid in rec.child_row(w)[:rec.nchild[w]]:
                            if buf[cid, 0, fi] == _NONE:
                                buf[cid, :3, fi] = (_SAMPLED,
                                                    samp_mean[kc, fi],
                                                    samp_std[kc, fi])
                                total[fi] += float(scost[cid, fi])
                        buf[tid, :3, fi] = _DEDUCED, cm[w, fi], cs[w, fi]
                        chosen[(tid, fi)] = rec.cands[w]
                        used[rec.child_row(w), fi] = True

            # ---- lines 10-11: fall back to SampleCF on this target ------
            rest = np.nonzero(act & ~has6 & ~has9)[0]
            if rest.size:
                buf[tid, 0, rest] = _SAMPLED
                buf[tid, 1, rest] = samp_mean[kc, rest]
                buf[tid, 2, rest] = samp_std[kc, rest]
                for fi_ in rest:
                    total[int(fi_)] += float(scost[tid, int(fi_)])

        return _RunState(g=g, targets=tuple(targets), f_grid=f_grid,
                         state=state, mean=buf[:, 1, :], std=buf[:, 2, :],
                         used=used, chosen=chosen, total=total)

    # ------------------------------------------------------------------
    # The torch backend: the whole greedy in one planner_walk call
    # ------------------------------------------------------------------
    def _pack(self, g: _Graph, scost: np.ndarray, samp_mean: np.ndarray,
              samp_std: np.ndarray, targets: Sequence[NodeKey]) -> tuple:
        """`g` and the plan's `targets` as the walk's packed arrays (see
        `planner_score.WalkGraph`), on the engine's device; also returns
        the host copies of the candidate offsets and child rows, which
        rebuild `chosen` and `used` from the walk's winners."""
        recs = g.recs
        n = len(g.node_keys)
        ncand = np.array([len(r.cands) for r in recs], dtype=np.int64)
        off = np.zeros(len(recs) + 1, dtype=np.int64)
        np.cumsum(ncand, out=off[1:])
        k = max([1] + [r.cx_ids.shape[1] for r in recs if r.cx_ids.size])
        child = np.full((int(off[-1]), k), n, dtype=np.int64)
        nchild = np.empty(int(off[-1]), dtype=np.int64)
        fac = np.empty((3, int(off[-1])))          # dm, vt, mq
        cs_dm, cs_msq, cs_vt = self._cs_fac
        for i, r in enumerate(recs):
            o, ncs = int(off[i]), r.ncs
            child[o:o + ncs, 0] = r.cs_ids
            fac[:, o:o + ncs] = np.array([[cs_dm], [cs_vt], [cs_msq]])
            ncx = len(r.cands) - ncs
            if ncx:
                ids = r.cx_ids
                child[o + ncs:o + ncs + ncx, :ids.shape[1]] = \
                    np.where(ids < 0, n, ids)
                fac[0, o + ncs:o + ncs + ncx] = r.cx_dm[:, 0]
                fac[1, o + ncs:o + ncs + ncx] = r.cx_vterm[:, 0]
                fac[2, o + ncs:o + ncs + ncx] = r.cx_msq[:, 0]
            nchild[o:o + len(r.cands)] = r.nchild
        tid = np.array([r.tid for r in recs], dtype=np.int64)
        kind = np.array([r.kind for r in recs], dtype=np.int64)
        tg = np.array([g.node_id[t] for t in targets], dtype=np.int64)
        ints = to_device([tid, kind, off, child, nchild, tg], np.int32,
                         self.device)
        dm, vt, mq = to_device(list(fac), np.float32, self.device)
        doubles = to_device([scost, samp_mean, samp_std], np.float64,
                            self.device)
        wg = _ps.WalkGraph(*ints[:5], dm, vt, mq, *doubles, targets=ints[5],
                           max_cands=int(ncand.max(initial=0)))
        return wg, off, child

    def _walk(self, g: _Graph, targets: Sequence[NodeKey],
              f_grid: Tuple[float, ...], scost: np.ndarray,
              samp_mean: np.ndarray, samp_std: np.ndarray, e: float,
              q: float, q_feas: float) -> "_RunState":
        """`_run` on a torch device: one `planner_walk` over the packed
        graph; `chosen` and `used` rebuilt from its winners."""
        wg, off, child = self._pack(g, scost, samp_mean, samp_std, targets)
        res = _ps.planner_walk(wg, e, q, q_feas)
        state, mean, std, win, total = (t.cpu().numpy() for t in res[:5])
        feasible = res.feasible.cpu().numpy()
        used = np.zeros(state.shape, dtype=bool)
        chosen: Dict[Tuple[int, int], Deduction] = {}
        rr, ff = np.nonzero(win >= 0)
        w = win[rr, ff] % _ps.WALK_LINE9            # candidate index
        used[child[off[rr] + w], ff[:, None]] = True
        for r, fi, wi in zip(rr.tolist(), ff.tolist(), w.tolist()):
            rec = g.recs[r]
            chosen[(rec.tid, fi)] = rec.cands[wi]
        return _RunState(g=g, targets=tuple(targets), f_grid=f_grid,
                         state=state, mean=mean, std=std, used=used,
                         chosen=chosen, total=total.tolist(),
                         feasible=feasible)

    # ------------------------------------------------------------------
    def _feasible_vec(self, st: "_RunState", e: float,
                      q: float) -> np.ndarray:
        """Per-f feasibility: every target's final RV satisfies (e, q);
        the walk's own verdict on a torch device."""
        if st.feasible is not None:
            return st.feasible
        tids = [st.g.node_id[t] for t in st.targets]
        m = st.mean[tids]                          # (ntargets, nf)
        s = st.std[tids]
        p = self._prob_cached(m.ravel(), s.ravel(), e).reshape(m.shape)
        return (p >= q).all(axis=0)

    def _assemble_one(self, st: "_RunState", fi: int,
                      feasible: bool) -> Plan:
        """Materialize fraction `fi`'s `Plan` (§5.2 lines 13-14 cleanup:
        keep only targets and used children)."""
        g = st.g
        f = st.f_grid[fi]
        n = st.state.shape[0] - 1   # nodes at run time
        is_target = np.zeros(n, dtype=bool)
        is_target[[g.node_id[t] for t in st.targets]] = True
        # pull the f column out as plain Python scalars once — per-node
        # numpy scalar indexing would dominate the assembly otherwise
        st_col = st.state[:, fi].tolist()
        m_col = st.mean[:, fi].tolist()
        s_col = st.std[:, fi].tolist()
        nodes: Dict[NodeKey, Node] = {}
        for nid in np.nonzero(st.used[:n, fi] | is_target)[0].tolist():
            k = g.node_keys[nid]
            if k in nodes:
                continue
            code = int(st_col[nid])
            if code == _NONE:
                raise RuntimeError(f"unresolved plan node {k.label()}")
            node = Node(k, _STATE_OF[code])
            if code == _SAMPLED:
                node.rv = err.samplecf_error(k.method, f)
            else:  # DEDUCED
                node.chosen = st.chosen[(nid, fi)]
                node.rv = err.ErrorRV(m_col[nid], s_col[nid])
            nodes[k] = node
        return Plan(f=f, nodes=nodes, targets=st.targets,
                    total_cost=st.total[fi], feasible=feasible)
