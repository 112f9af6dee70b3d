"""Batched §5.2 deduction planner: the greedy graph search as array code.

The engine runs the greedy for **all sampling fractions in one pass over a
shared deduction graph**:

* **Graph build (f-independent, built once).**  The node universe and each
  target's candidate-deduction set do not depend on f: ColSet mates can only
  be pre-existing nodes (existing indexes, §5.1, and targets), never nodes
  materialized mid-walk — a materialized child is strictly narrower than
  its creator, and the walk is narrow-to-wide, so it can never share a
  column set with a later target.  Existing indexes enter the universe
  first and start every run EXACT (zero cost, zero error).  The build
  records, per target in processing order, the candidate `Deduction`s
  with their children packed into (ncand, K) id arrays (EXACT-padded),
  plus the deduction-error term of each candidate.

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

Persistent state (the online `AdvisorSession`).  One engine serves every
round of a session: its node universe is append-only (node ids stay
stable across target-set deltas), built graphs are cached by target
tuple, and target records by (target, mate-group version), so a delta
round rebuilds only the records whose ColSet mate group changed.  With
`record=True` the engine also replays decisions across runs:

* numpy backend, per record, as the JAX package does: each target's
  decision is stored with the pre-decision view of its inputs, and
  replayed when the view is bit-identical this round (the run's dirty
  flags prove most views untouched without a compare); a record whose
  mate group changed is verified by scoring only the inserted mates
  (`_verify_changed`).  The counters equal the reference's numpy engine's.
* torch backend, per plan: the last walk's `_RunState` is kept per
  (e, q, q_feas) with its target tuple.  A walk is a pure function of the
  packed graph, which the target tuple fixes while the universe stands,
  so a run on the same targets returns the stored walk (every target
  counts in `replay_hits`) and any other runs one `planner_walk` launch
  (every target counts in `replay_misses`).  A fresh walk is a fresh
  `recommend`'s plan, so a session equals a fresh advisor within the
  torch backend.

Both replay stores hold only recomputable state: `max_replay` clears one
that outgrows it, a firing "planner_replay" fault (`faults.FaultInjector`)
drops it, and when the universe outgrows `max_nodes` an epoch eviction
resets the universe and everything keyed by node ids.
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


def assert_plan_identical(ref: Plan, got: Plan, label: str = "") -> None:
    """Plan identity: the same f, targets and nodes, each with the same
    state, chosen deduction, error RV and exact size, the same total_cost
    and feasibility (the JAX package's contract between its planners)."""
    tag = f"{label}: " if label else ""
    assert got.f == ref.f and got.targets == ref.targets, \
        tag + "plan identity (f / targets) diverged"
    assert set(got.nodes) == set(ref.nodes), f"{tag}node sets diverged"
    for k, na in ref.nodes.items():
        nb = got.nodes[k]
        assert na.state is nb.state, f"{tag}state diverged at {k.label()}"
        assert na.chosen == nb.chosen, \
            f"{tag}chosen deduction diverged at {k.label()}"
        assert na.rv == nb.rv, f"{tag}error RV diverged at {k.label()}"
        assert na.exact_bytes == nb.exact_bytes, \
            f"{tag}exact size diverged at {k.label()}"
    assert got.total_cost == ref.total_cost, \
        f"{tag}total_cost {got.total_cost} != {ref.total_cost}"
    assert got.feasible == ref.feasible, tag + "feasibility diverged"


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
    all_child_ids: np.ndarray = None  # unique child ids (replay dirty check)
    ver: int = -1            # mate-group version this record was built at
    pos: int = -1            # own position in the mate group

    def child_row(self, w: int) -> np.ndarray:
        """Child-id row of candidate `w` in candidate order."""
        if w < self.ncs:
            return self.cs_ids[w:w + 1]
        return self.cx_ids[w - self.ncs]


@dataclasses.dataclass
class _Graph:
    """One round's view of the engine's LIVE append-only node universe
    (`node_keys` / `node_id`, ids stable across target-set deltas), the
    existing indexes as (node id, key, bytes), and the round's target
    records in processing order."""
    node_keys: List[NodeKey]
    node_id: Dict[NodeKey, int]
    exact: List[Tuple[int, NodeKey, float]]
    recs: List[_TargetRec]


@dataclasses.dataclass
class _RecReplay:
    """One target's recorded decision from a previous numpy `_run` (same
    e, q): the pre-decision view of its inputs and the writes it produced.
    A decision is a pure function of (candidate record, input view, e, q,
    sampling costs), so when the view is bit-identical this round,
    replaying the stored writes is exactly what re-scoring would produce."""
    rec: _TargetRec              # identity-checked (record cache object)
    view_tid: np.ndarray         # (4, nf) buf[tid] before the decision
    view_ch: Optional[tuple]     # per-block child gathers, or None
    post_tid: np.ndarray         # (3, nf) buf[tid, :3] after the decision
    written: np.ndarray          # node ids whose value this rec wrote
    child_w: Optional[tuple]     # (cids, fis, means, stds) sampled children
    used_w: Optional[tuple]      # (ids, fis) used-as-child flag writes
    chosen: dict                 # {(tid, fi): Deduction}
    totals: List[tuple]          # ordered (fi, cost) total accumulations


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
    """Runs the §5.2 greedy for a whole f grid over one shared graph.

    `existing` maps the NodeKeys of existing indexes to their bytes: they
    are EXACT in every plan (§5.1).  It is fixed for the engine's life, so
    no stored walk or decision of one `existing` can serve another.
    `record` turns on the cross-run replay of a long-lived engine;
    `max_nodes` / `max_replay` bound its universe and replay store;
    `faults` is an optional `faults.FaultInjector` (site
    "planner_replay")."""

    def __init__(self, tables: Dict, existing: Optional[Dict] = None,
                 device: Optional[torch.device] = None,
                 record: bool = False, max_nodes: Optional[int] = None,
                 max_replay: Optional[int] = None, faults=None):
        self.device = device
        self.tables = tables
        self.existing = dict(existing or {})
        self.record = record
        self.max_nodes = max_nodes
        self.max_replay = max_replay
        self.faults = faults
        self._graphs: Dict[Tuple[NodeKey, ...], _Graph] = {}
        self._scost: Dict[Tuple[str, Tuple[str, ...], float], float] = {}
        self._pcache: Dict[Tuple[float, float, float], float] = {}
        # append-only node universe, the existing indexes first
        self._node_keys: List[NodeKey] = []
        self._node_id: Dict[NodeKey, int] = {}
        self._exact: List[Tuple[int, NodeKey, float]] = [
            (self._add_node(k), k, size) for k, size in self.existing.items()]
        # (target, mate-group version) -> packed _TargetRec
        self._recs: Dict[Tuple[NodeKey, int], _TargetRec] = {}
        # (table, column set, method) -> [mates tuple, ids, pos map,
        # shared Deduction list, version, last transition]; the version
        # bumps when membership changes, invalidating members' records
        self._groups: Dict[Tuple[str, frozenset, str], list] = {}
        # target -> packed ColExt block (pure in the target; never stale)
        self._colext: Dict[NodeKey, tuple] = {}
        rv = err.colset_error()
        self._cs_fac = (rv.mean, rv.mean * rv.mean,
                        rv.std * rv.std + rv.mean * rv.mean)
        # per-f-grid (node x f) §5.1 cost columns, grown with the universe
        self._scost_cols: Dict[Tuple[float, ...], list] = {}
        # numpy: (e, q) -> per-target _RecReplay decision records
        self._replay: Dict[Tuple, Dict[NodeKey, _RecReplay]] = {}
        # torch: (e, q, q_feas) -> (target tuple, its walk's _RunState)
        self._walks: Dict[tuple, Tuple[tuple, _RunState]] = {}
        self.graph_builds = 0     # distinct target sets built
        self.batch_runs = 0       # _run invocations
        self.rec_builds = 0       # target records packed from scratch
        self.rec_hits = 0         # target records reused from the cache
        self.replay_hits = 0      # per-target decisions replayed
        self.replay_verified = 0  # ... replayed after appended-mate checks
        self.replay_misses = 0    # ... recomputed
        self.universe_evictions = 0  # epoch resets of the node universe
        self.replay_evictions = 0    # replay stores dropped at max_replay
        self.replay_faults = 0       # ... dropped by injected faults
        self.peak_nodes = 0          # high-water mark of the universe

    # ------------------------------------------------------------------
    # Graph construction (f-independent; incremental over a shared node
    # universe, with per-(target, mates) record caching)
    # ------------------------------------------------------------------
    def _add_node(self, k: NodeKey) -> int:
        nid = self._node_id.get(k)
        if nid is None:
            nid = self._node_id[k] = len(self._node_keys)
            self._node_keys.append(k)
        return nid

    def _colext_block(self, t: NodeKey) -> tuple:
        """Packed ColExt candidates of `t`, pure in the target and cached.
        Pad id is -1: it always indexes the LAST buf row, which every
        `_run` allocates as the virtual EXACT node (neutral under compose,
        zero cost), however much the universe grows."""
        got = self._colext.get(t)
        if got is not None:
            return got
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
        got = self._colext[t] = (cands, cx_ids, nchild, dm, msq,
                                 ds * ds + msq)
        return got

    def _build_rec(self, t: NodeKey, group: Optional[list]) -> _TargetRec:
        cx_cands, cx_ids, cx_nchild, cx_dm, cx_msq, cx_vt = \
            self._colext_block(t)
        if group is None:
            cs_cands: List[Deduction] = []
            cs_ids = np.empty(0, dtype=np.int64)
            ver = pos = -1
        else:
            _, ids, pos_map, ded_list, ver, _ = group
            pos = pos_map[t]
            cs_cands = ded_list[:pos] + ded_list[pos + 1:]
            cs_ids = np.delete(ids, pos)
        cands = tuple(cs_cands) + tuple(cx_cands)
        nchild = [1] * len(cs_cands) + list(cx_nchild)
        all_ids = np.unique(np.concatenate([cs_ids, cx_ids.ravel()])) \
            if cands else np.empty(0, dtype=np.int64)
        return _TargetRec(self._node_id[t], t, _kind_code(t.method), cands,
                          len(cs_cands), cs_ids, cx_ids, nchild,
                          cx_dm, cx_msq, cx_vt, all_ids, ver, pos)

    def _build_graph(self, targets: Sequence[NodeKey]) -> _Graph:
        # ColSet mate groups: (table, column set, method) -> members, the
        # existing indexes first, then targets in first-seen order
        by_set: Dict[Tuple[str, frozenset, str], List[NodeKey]] = {}
        for _, k, _ in self._exact:
            by_set.setdefault(k.gkey(), []).append(k)
        seen = set()
        for t in targets:
            self._add_node(t)
            if t not in seen:
                seen.add(t)
                by_set.setdefault(t.gkey(), []).append(t)

        # group registry: bump the version (and drop members' stale
        # records) only when a group's membership changed; the bump's
        # survivor / insert masks are kept for `_verify_changed`
        for gk, members in by_set.items():
            mt = tuple(members)
            reg = self._groups.get(gk)
            if reg is not None and reg[0] == mt:
                continue
            ver = 0 if reg is None else reg[4] + 1
            ids = np.array([self._node_id[m] for m in mt], dtype=np.int64)
            trans = None
            if reg is not None:
                for m in reg[0]:
                    self._recs.pop((m, reg[4]), None)
                old_ids = reg[1]
                kept_old_g = np.isin(old_ids, ids, assume_unique=True)
                kept_new_g = np.isin(ids, old_ids, assume_unique=True)
                order_ok = bool(np.array_equal(ids[kept_new_g],
                                               old_ids[kept_old_g]))
                trans = (reg[4], kept_old_g, kept_new_g, order_ok)
            pos_map = {m: i for i, m in enumerate(mt)}
            ded_list = [_colset_ded(o) for o in mt]
            self._groups[gk] = [mt, ids, pos_map, ded_list, ver, trans]

        recs: List[_TargetRec] = []
        for t in sorted(targets, key=lambda k: (len(k.cols), k.cols)):
            if METHODS[t.method].order_dependent:
                group = None
                rkey = (t, -1)
            else:
                group = self._groups[t.gkey()]
                rkey = (t, group[4])
            rec = self._recs.get(rkey)
            if rec is None:
                rec = self._recs[rkey] = self._build_rec(t, group)
                self.rec_builds += 1
            else:
                self.rec_hits += 1
            recs.append(rec)
        return _Graph(self._node_keys, self._node_id, list(self._exact),
                      recs)

    def _evict_universe(self) -> None:
        """Epoch eviction: reset the node universe and everything keyed by
        (or holding) node ids.  The §5.1 cost memo and the probability
        memo survive (they are id-free); every dropped structure is a pure
        function of the next round's targets, so the rebuild is
        bit-identical."""
        self._graphs.clear()
        self._recs.clear()
        self._groups.clear()
        self._colext.clear()
        self._scost_cols.clear()
        self._replay.clear()
        self._walks.clear()
        self._node_keys = []
        self._node_id = {}
        self._exact = [(self._add_node(k), k, size)
                       for k, size in self.existing.items()]
        self.universe_evictions += 1

    def _graph(self, targets: Sequence[NodeKey]) -> _Graph:
        if self.max_nodes is not None and \
                len(self._node_keys) > self.max_nodes:
            self._evict_universe()
        key = tuple(targets)
        g = self._graphs.get(key)
        if g is None:
            if len(self._graphs) > 128:   # bound a long session's footprint
                self._graphs.clear()
            g = self._graphs[key] = self._build_graph(targets)
            self.graph_builds += 1
        self.peak_nodes = max(self.peak_nodes, len(self._node_keys))
        return g

    def _sampling_cost(self, key: NodeKey, f: float) -> float:
        return memoized_sampling_cost(self.tables, self._scost, key, f)

    def replay_entries(self) -> int:
        """Targets held by the replay store: recorded decisions on numpy,
        the memoized walks' targets on torch."""
        return (sum(len(d) for d in self._replay.values())
                + sum(len(st.g.recs) for _, st in self._walks.values()))

    def _trim_replay(self) -> None:
        """Before a recording run: drop the replay store on a firing
        "planner_replay" fault, or once it holds more than `max_replay`
        targets (the next run recomputes, bit-identically)."""
        if self.faults is not None and self.faults.fires("planner_replay"):
            if self._replay or self._walks:
                self._replay.clear()
                self._walks.clear()
                self.replay_faults += 1
        if self.max_replay is not None and \
                self.replay_entries() > self.max_replay:
            self._replay.clear()
            self._walks.clear()
            self.replay_evictions += 1

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
        """(node x f) §5.1 sampling costs of the universe's first
        len(g.node_keys) nodes, grown incrementally with the universe."""
        n = len(g.node_keys)
        ent = self._scost_cols.get(f_grid)
        if ent is None:
            ent = self._scost_cols[f_grid] = \
                [np.zeros((max(n, 64), len(f_grid))), 0]
        if n > ent[0].shape[0]:
            grown = np.zeros((max(n, 2 * ent[0].shape[0]), len(f_grid)))
            grown[:ent[0].shape[0]] = ent[0]
            ent[0] = grown
        arr, filled = ent
        if filled < n:
            for nid in range(filled, n):
                k = g.node_keys[nid]
                for fi, f in enumerate(f_grid):
                    arr[nid, fi] = self._sampling_cost(k, f)
            ent[1] = n
        return arr[:n]

    def greedy_batch(self, targets: Sequence[NodeKey], e: float, q: float,
                     f_grid: Sequence[float] = F_GRID) -> List[Plan]:
        """One `Plan` per fraction in `f_grid` from one pass (one
        `planner_walk` launch on a torch device)."""
        st = self._run(targets, e, q, f_grid=tuple(f_grid))
        feas = self._feasible_vec(st, e, q)
        return [self._assemble_one(st, fi, bool(feas[fi]))
                for fi in range(len(st.f_grid))]

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
    def _gather(rec: _TargetRec, buf: np.ndarray) -> tuple:
        """Pre-decision child views, one per block: ((ncs, 4, nf) ColSet
        children, (ncx, K, 4, nf) ColExt children), None when empty."""
        return (buf[rec.cs_ids] if rec.ncs else None,
                buf[rec.cx_ids] if len(rec.cands) > rec.ncs else None)

    @staticmethod
    def _views_equal(a: tuple, b: tuple) -> bool:
        for x, y in zip(a, b):
            if (x is None) != (y is None):
                return False
            if x is not None and not np.array_equal(x, y):
                return False
        return True

    @staticmethod
    def _concat(a: Optional[np.ndarray],
                b: Optional[np.ndarray]) -> np.ndarray:
        if a is None:
            return b
        if b is None:
            return a
        return np.concatenate([a, b], axis=0)

    def _verify_changed(self, rec: _TargetRec, rr: _RecReplay,
                        buf: np.ndarray, dirty: np.ndarray, e: float,
                        q: float, samp_mean: np.ndarray,
                        samp_std: np.ndarray, scost: np.ndarray) -> tuple:
        """Decision-level replay check for a target whose candidate RECORD
        changed.  A record only changes through its ColSet mate group, and
        group deltas preserve the survivors' relative order (the candidate
        union is kept in a canonical sorted order): mates are removed or
        inserted, never permuted.  The §5.2 choice is a first-max argmax
        (or first-min argmin), so the recorded decision still stands iff no
        removed candidate was the winner and no inserted candidate would
        now qualify ahead of it — checkable by scoring ONLY the inserted
        candidates.  Returns (ok, view_ch): ok=True means the stored writes
        replay verbatim with `view_ch` as the record's refreshed view."""
        tid = rec.tid
        if dirty[tid] and not np.array_equal(rr.view_tid, buf[tid]):
            return False, None
        act = rr.view_tid[0] == _NONE
        if rr.view_ch is None:
            # recorded with no reads (fully-decided target): the matching
            # state row already proves the no-op decision stands
            return (not act.any()), None
        old_ids = rr.rec.cs_ids
        new_ids = rec.cs_ids
        group = self._groups.get(rec.key.gkey())
        trans = group[5] if group is not None else None
        if (trans is not None and trans[0] == rr.rec.ver
                and group[4] == rec.ver and rr.rec.pos >= 0):
            # the group's last transition covers exactly this old->new
            # record pair: derive the member masks by dropping self
            if not trans[3]:
                return False, None     # survivors permuted: full rescore
            kept_old = np.delete(trans[1], rr.rec.pos)
            kept_new = np.delete(trans[2], rec.pos)
        else:
            kept_new = np.isin(new_ids, old_ids, assume_unique=True)
            kept_old = np.isin(old_ids, new_ids, assume_unique=True)
            if not np.array_equal(new_ids[kept_new], old_ids[kept_old]):
                return False, None     # survivors permuted: full rescore
        old_chs, old_chx = rr.view_ch
        surv = new_ids[kept_new]
        ncx = len(rec.cands) - rec.ncs
        trusted = (not dirty[tid]
                   and (not surv.size or not dirty[surv].any())
                   and (not ncx or not dirty[rec.cx_ids].any()))
        ins = ~kept_new
        nins = int(ins.sum())
        if trusted:
            # untouched inputs are bit-identical by the run invariant:
            # reuse the recorded rows, gather only the inserted mates
            chx = old_chx
            app = buf[new_ids[ins]] if nins else None
            if new_ids.size:
                chs = np.empty(
                    (new_ids.shape[0],) + rr.view_tid.shape, dtype=np.float64)
                if surv.size:
                    chs[kept_new] = old_chs[kept_old]
                if nins:
                    chs[ins] = app
            else:
                chs = None
        else:
            chs = buf[new_ids] if new_ids.size else None
            chx = buf[rec.cx_ids] if ncx else None
            if (chx is None) != (old_chx is None) or \
                    (chx is not None and not np.array_equal(chx, old_chx)):
                return False, None
            if kept_old.any() and \
                    not np.array_equal(chs[kept_new], old_chs[kept_old]):
                return False, None
            app = chs[ins] if nins else None
        removed_set = (set(old_ids[~kept_old].tolist())
                       if not kept_old.all() else ())
        nf = act.shape[0]
        if nins:
            # score just the inserted single-child ColSet candidates
            ins_pos = np.nonzero(ins)[0]
            known = app[:, 0, :] != _NONE
            m_a = app[:, 1, :]
            s_a = app[:, 2, :]
            if not known.all():
                m_a = np.where(known, m_a, samp_mean[rec.kind])
                s_a = np.where(known, s_a, samp_std[rec.kind])
            cs_dm, cs_msq, cs_vt = self._cs_fac
            elig67 = known & act              # single child: allk == known
            pre9 = ~known & (app[:, 3, :] < scost[rec.tid]) & act
            msq = m_a * m_a
            cm_a = m_a * cs_dm
            v_a = (s_a * s_a + msq) * cs_vt
            e2_a = msq * cs_msq
            std_a = np.sqrt(np.maximum(v_a - e2_a, 0.0))
            maskp = elig67 | pre9
            p = np.zeros((nins, nf))
            ii = maskp.nonzero()
            if ii[0].size:
                p[ii] = self._prob_cached(cm_a[ii], std_a[ii], e)
            sat = p >= q
            pos_of = {int(v): i for i, v in enumerate(new_ids)}
        b9 = set(rr.child_w[1].tolist()) if rr.child_w is not None else ()
        for fi in np.nonzero(act)[0].tolist():
            if rr.post_tid[0, fi] == _DEDUCED and fi not in b9:
                # old decision: lines 6-7 winner.  It stands unless it was
                # removed, or an inserted candidate now scores ahead of it
                # (strictly better p; or equal p at an earlier position —
                # every inserted ColSet precedes every ColExt candidate).
                d = rr.chosen[(tid, fi)]
                is_cx = d.kind == "colext"
                wid = None if is_cx else self._node_id[d.children[0]]
                if removed_set and wid is not None and wid in removed_set:
                    return False, (chs, chx)
                if nins:
                    el = elig67[:, fi] & sat[:, fi]
                    if el.any():
                        best_p = self._prob_cached(
                            np.array([rr.post_tid[1, fi]]),
                            np.array([rr.post_tid[2, fi]]), e)[0]
                        pm = p[el, fi].max()
                        if pm > best_p or (pm == best_p and is_cx):
                            return False, (chs, chx)
                        if pm == best_p:
                            tie = el & (p[:, fi] == best_p)
                            if (ins_pos[tie] < pos_of[wid]).any():
                                return False, (chs, chx)
            else:
                # old decision: lines 8-9 (fi in b9) or 10-11 fallback.
                # Any newly eligible inserted candidate re-opens it; so
                # does removing a lines-8-9 winner.
                if fi in b9 and removed_set:
                    d = rr.chosen.get((tid, fi))
                    if d is not None and d.kind == "colset" and \
                            self._node_id[d.children[0]] in removed_set:
                        return False, (chs, chx)
                if nins and (sat[:, fi]
                             & (elig67[:, fi] | pre9[:, fi])).any():
                    return False, (chs, chx)
        return True, (chs, chx)

    @staticmethod
    def _replay_rec(rr: _RecReplay, buf: np.ndarray, used: np.ndarray,
                    chosen: Dict, total: List[float]) -> None:
        """Replay a recorded decision: write the stored post-state.  The
        stored floats ARE the values recomputation would produce (the
        pre-decision view is bit-identical), so the run stays exact."""
        buf[rr.rec.tid, :3, :] = rr.post_tid
        if rr.child_w is not None:
            cids, fis, ms, ss = rr.child_w
            buf[cids, 0, fis] = _SAMPLED
            buf[cids, 1, fis] = ms
            buf[cids, 2, fis] = ss
        if rr.used_w is not None:
            used[rr.used_w[0], rr.used_w[1]] = True
        if rr.chosen:
            chosen.update(rr.chosen)
        for fi, c in rr.totals:
            total[fi] += c

    def _run(self, targets: Sequence[NodeKey], e: float, q: float,
             q_feas: Optional[float] = None,
             f_grid: Tuple[float, ...] = F_GRID) -> "_RunState":
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

        With `record`, decisions replay across runs (the module
        docstring): per record on numpy, per walk on torch.
        """
        self.batch_runs += 1
        f_grid = tuple(f_grid)
        if self.record:
            self._trim_replay()
        g = self._graph(targets)
        nf = len(f_grid)
        n = len(g.node_keys)
        pad = n   # child_ids pad id -1 wraps to this last row
        if self.device is not None:
            wkey = (e, q, q if q_feas is None else q_feas, f_grid)
            held = self._walks.get(wkey)
            if held is not None and held[0] == tuple(targets):
                self.replay_hits += len(g.recs)
                return held[1]

        # packed per-(node, f) state: [state code, rv mean, rv std, cost]
        # — one fancy-index gathers everything a candidate row needs
        buf = np.zeros((n + 1, 4, nf))
        buf[:, 1, :] = 1.0                        # default rv = EXACT
        buf[pad, 0, :] = _EXACT
        for nid, _, _ in g.exact:
            buf[nid, 0, :] = _EXACT
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
            st = self._walk(g, targets, f_grid, scost, samp_mean, samp_std,
                            e, q, wkey[2])
            self.replay_misses += len(g.recs)
            if self.record:
                self._walks[wkey] = (tuple(targets), st)
            return st

        total = [0.0] * nf
        used = np.zeros((n + 1, nf), dtype=bool)
        chosen: Dict[Tuple[int, int], Deduction] = {}
        false_f = np.zeros(nf, dtype=bool)
        store = (self._replay.setdefault((e, q, f_grid), {})
                 if self.record else None)

        # dirty-node pre-pass: a target that vanished from the round leaves
        # its recorded writes unapplied — flag (and forget) them so every
        # dependent takes the compare path instead of the fast one
        dirty = np.zeros(n + 1, dtype=bool)
        if store:
            cur = {rec.key for rec in g.recs}
            for k in [k for k in store if k not in cur]:
                dirty[store[k].written] = True
                del store[k]

        for rec in g.recs:
            tid = rec.tid
            rr = store.get(rec.key) if store is not None else None
            fresh = rr is not None and rr.rec is rec
            if (fresh and not dirty[tid]
                    and not dirty[rec.all_child_ids].any()):
                # fast path: nothing this rec reads was touched this round,
                # so its input view is bit-identical by induction
                self.replay_hits += 1
                self._replay_rec(rr, buf, used, chosen, total)
                continue
            tview = buf[tid].copy() if store is not None else None
            ch = None
            if fresh and np.array_equal(rr.view_tid, tview):
                if rr.view_ch is not None:
                    ch = self._gather(rec, buf)
                if rr.view_ch is None or self._views_equal(rr.view_ch, ch):
                    # inputs bit-identical despite dirty neighbors: the
                    # replayed writes reproduce last round's values, so
                    # nothing new becomes dirty
                    self.replay_hits += 1
                    self._replay_rec(rr, buf, used, chosen, total)
                    continue
            elif rr is not None and rr.rec is not rec:
                # candidate record changed (mate-group delta): decision-
                # level verification scores only the inserted mates
                ok, ch = self._verify_changed(
                    rec, rr, buf, dirty, e, q, samp_mean, samp_std, scost)
                if ok:
                    self.replay_verified += 1
                    self._replay_rec(rr, buf, used, chosen, total)
                    store[rec.key] = dataclasses.replace(
                        rr, rec=rec, view_ch=ch)
                    continue
            self.replay_misses += 1
            r_chosen: Dict[Tuple[int, int], Deduction] = {}
            r_used: List[Tuple[np.ndarray, int]] = []
            r_child: List[Tuple[int, int, float, float]] = []
            r_tot: List[Tuple[int, float]] = []
            act = state[tid] == _NONE              # (nf,)
            nc = len(rec.cands) if act.any() else 0
            kc = rec.kind
            has6 = has9 = false_f
            if nc:
                if ch is None:
                    ch = self._gather(rec, buf)
                chs, chx = ch                      # per-block child views
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
                        r_chosen[(tid, fi)] = rec.cands[w]
                        r_used.append((rec.child_row(w), fi))

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
                                c = float(scost[cid, fi])
                                total[fi] += c
                                r_child.append((int(cid), fi,
                                                float(samp_mean[kc, fi]),
                                                float(samp_std[kc, fi])))
                                r_tot.append((fi, c))
                        buf[tid, :3, fi] = _DEDUCED, cm[w, fi], cs[w, fi]
                        chosen[(tid, fi)] = rec.cands[w]
                        used[rec.child_row(w), fi] = True
                        r_chosen[(tid, fi)] = rec.cands[w]
                        r_used.append((rec.child_row(w), fi))

            # ---- lines 10-11: fall back to SampleCF on this target ------
            rest = np.nonzero(act & ~has6 & ~has9)[0]
            if rest.size:
                buf[tid, 0, rest] = _SAMPLED
                buf[tid, 1, rest] = samp_mean[kc, rest]
                buf[tid, 2, rest] = samp_std[kc, rest]
                for fi_ in rest:
                    fi = int(fi_)
                    c = float(scost[tid, fi])
                    total[fi] += c
                    r_tot.append((fi, c))

            # ---- record the decision + propagate dirtiness --------------
            if store is None:
                continue
            if r_child:
                cids = np.array([x[0] for x in r_child], dtype=np.int64)
                child_w = (cids,
                           np.array([x[1] for x in r_child], dtype=np.int64),
                           np.array([x[2] for x in r_child]),
                           np.array([x[3] for x in r_child]))
                written = np.unique(np.concatenate(
                    [np.array([tid], dtype=np.int64), cids]))
            else:
                child_w = None
                written = (np.array([tid], dtype=np.int64) if act.any()
                           else np.empty(0, dtype=np.int64))
            if r_used:
                used_w = (np.concatenate([u[0] for u in r_used]),
                          np.repeat(
                              np.array([u[1] for u in r_used],
                                       dtype=np.int64),
                              np.array([u[0].shape[0] for u in r_used])))
            else:
                used_w = None
            rr2 = _RecReplay(rec, tview, ch, buf[tid, :3, :].copy(),
                             written, child_w, used_w, r_chosen, r_tot)
            if rr is not None:
                dirty[rr.written] = True
            if written.size:
                dirty[written] = True
            store[rec.key] = rr2

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
        ex = np.array([nid for nid, _, _ in g.exact], dtype=np.int64)
        ints = to_device([tid, kind, off, child, nchild, tg, ex], np.int32,
                         self.device)
        dm, vt, mq = to_device(list(fac), np.float32, self.device)
        doubles = to_device([scost, samp_mean, samp_std], np.float64,
                            self.device)
        wg = _ps.WalkGraph(*ints[:5], dm, vt, mq, *doubles, targets=ints[5],
                           max_cands=int(ncand.max(initial=0)),
                           exact=ints[6])
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
        keep only targets, used children and the EXACT existing nodes)."""
        g = st.g
        f = st.f_grid[fi]
        n = st.state.shape[0] - 1   # nodes at run time (universe may grow)
        is_target = np.zeros(n, dtype=bool)
        is_target[[g.node_id[t] for t in st.targets]] = True
        # pull the f column out as plain Python scalars once — per-node
        # numpy scalar indexing would dominate the assembly otherwise
        st_col = st.state[:, fi].tolist()
        m_col = st.mean[:, fi].tolist()
        s_col = st.std[:, fi].tolist()
        nodes: Dict[NodeKey, Node] = {}
        for _, k, size in g.exact:
            nodes[k] = Node(k, State.EXACT, rv=err.EXACT, exact_bytes=size)
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
