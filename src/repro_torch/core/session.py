"""Online advisor sessions: delta-aware re-advising over long-lived engines.

A `DesignAdvisor.recommend` rebuilds the candidate universe, the cost
matrices, the deduction graph and every size estimate from scratch.  An
`AdvisorSession` owns persistent engines instead and takes workload deltas
(`add_statements` / `remove_statements` / `reweight`, or one
`WorkloadDelta` through `apply`) followed by `recommend(budget)` calls
whose cost follows the delta:

* **Candidate universe** -- per-query syntactic candidates and their
  compression expansions are pure in the query, cached by statement name;
  only the (order-sensitive, cheap) dedup and merge pass re-runs.
* **Size estimation** -- the persistent `PlannerEngine` keeps its node
  universe and target records across rounds and replays decisions (per
  record on numpy; per plan on torch, where a re-planned round is one
  `planner_walk` launch and an unchanged target set none), and SAMPLED
  estimates are cached by (NodeKey, f), so SampleCF (and its codec
  kernels on the card) runs only for cache misses.
* **What-if costing** -- the persistent `CostEngine` appends and drops
  statement rows and refreshes only the columns whose registered size
  changed (`apply_delta` / `sync_sizes`).  `peek_cost_jobs` /
  `accept_cost_results` let a caller prefetch candidate costs for the next
  `recommend`.
* **Selection** -- per-query skyline / top-k selections are reused unless
  a delta re-sized one of the query's candidates.

Correctness contract: after ANY delta sequence, `recommend` returns a
recommendation identical (config, cost, used_bytes, plan counts, pool) to
a fresh `DesignAdvisor` with the same options on the resulting workload,
on each backend: every stage runs the one-shot advisor's code or reuses
values that are pure functions of the same inputs.  A session runs where
its options say (`backend` / `device`), on the card unless the caller
asks for the CPU.  The options' `use_*` switches move their phase to its
statement-at-a-time reference here as in `DesignAdvisor`: the planner to
`greedy_scalar`, SampleCF misses to one `sample_cf` each, and costing and
enumeration (with `use_engine=False`, no `CostEngine` is kept) to the
session's `WhatIfOptimizer`.

`snapshot` / `restore` checkpoint a session (the workload, options,
retired names, version and the warm estimates; no tensor), and
`SessionSnapshot.to_bytes` frames it with the JAX package's header (magic,
format version, payload length, CRC32).  The options are part of the
snapshot, so one taken with `device="cuda"` restores only where CUDA is.
"""
from __future__ import annotations

import dataclasses
import pickle
import struct
import time
import zlib
from typing import Dict, Iterable, List, Mapping, Optional, Set, Tuple, Union

from . import candidates as cand
from .advisor import (AdvisorOptions, Recommendation, enumerate_pool,
                      pool_with_merged, select_candidates)
from .backend import resolve_device
from .cost_engine import CostEngine
from .estimation_engine import EstimationEngine
from .estimation_graph import EstimationPlanner, NodeKey, Plan, State
from .faults import FaultInjector
from .relation import IndexDef
from .samplecf import EstimateCache, SampleManager, SizeEstimate
from .whatif import SizeProvider, WhatIfOptimizer, base_configuration
from .workload import Query, Statement, Workload, WorkloadDelta
from .workload_compression import ClusterIndex, CompressedWorkload


@dataclasses.dataclass
class _QueryEntry:
    """Per-statement candidate cache (pure in the query)."""
    raw: List[IndexDef]        # syntactically relevant candidates
    exp: List[IndexDef]        # compression-expanded candidates
    key_set: frozenset         # exp candidates' index keys (invalidation)


@dataclasses.dataclass
class _Selection:
    """Per-statement §6.1 selection cache (pure in query + sizes)."""
    selected: List[cand.Candidate]
    n_costed: int


#: Serialized-snapshot framing: magic + format version + payload length
#: + CRC32(payload), then the pickled snapshot; byte-identical to the JAX
#: package's header.  It lets `from_bytes` tell tampered or truncated bytes
#: (SnapshotCorrupt, with the offset and both checksums) from a different
#: format version.
SNAPSHOT_MAGIC = b"RSNP"
SNAPSHOT_FORMAT_VERSION = 1
_SNAP_HEADER = struct.Struct("<4sHII")   # magic, version, length, crc32


class SnapshotCorrupt(ValueError):
    """Serialized `SessionSnapshot` bytes failed validation.

    `offset` is the byte offset of the failure; for checksum failures
    `expected_crc` / `actual_crc` carry the header CRC vs the CRC of the
    bytes actually present."""

    def __init__(self, msg: str, offset: int = 0,
                 expected_crc: Optional[int] = None,
                 actual_crc: Optional[int] = None):
        detail = f"{msg} (at byte {offset}"
        if expected_crc is not None:
            detail += (f"; checksum expected {expected_crc:#010x}, "
                       f"actual {actual_crc:#010x}")
        super().__init__(detail + ")")
        self.offset = offset
        self.expected_crc = expected_crc
        self.actual_crc = actual_crc


@dataclasses.dataclass
class SessionSnapshot:
    """Self-contained checkpoint of an `AdvisorSession`.

    Captures exactly the state the parity contract depends on -- the
    workload (schema + statements), the options, the retired-name set and
    the monotone workload version -- plus the warm (NodeKey, f) SampleCF
    estimates (pure in (schema content, sample seed, NodeKey, f), so
    carrying them only saves recomputation).  Everything else a session
    holds is rebuilt by `AdvisorSession.restore`, whose next recommend is
    `==` a fresh `DesignAdvisor` on the snapshot workload."""
    workload: Workload
    options: AdvisorOptions
    workload_version: int
    retired: frozenset
    estimates: Dict[Tuple[NodeKey, float], SizeEstimate]

    def to_bytes(self) -> bytes:
        payload = pickle.dumps(self)
        return _SNAP_HEADER.pack(SNAPSHOT_MAGIC, SNAPSHOT_FORMAT_VERSION,
                                 len(payload), zlib.crc32(payload)) + payload

    @staticmethod
    def from_bytes(data: bytes) -> "SessionSnapshot":
        data = bytes(data)
        if len(data) < _SNAP_HEADER.size:
            raise SnapshotCorrupt(
                f"truncated snapshot: {len(data)} bytes is shorter than "
                f"the {_SNAP_HEADER.size}-byte header", offset=len(data))
        magic, version, length, crc = _SNAP_HEADER.unpack_from(data, 0)
        if magic != SNAPSHOT_MAGIC:
            raise SnapshotCorrupt(
                f"bad magic {magic!r} (expected {SNAPSHOT_MAGIC!r}) — not "
                "a serialized SessionSnapshot", offset=0)
        if version != SNAPSHOT_FORMAT_VERSION:
            raise SnapshotCorrupt(
                f"snapshot format version {version} is not supported by "
                f"this build (supported version: "
                f"{SNAPSHOT_FORMAT_VERSION})", offset=4)
        if len(data) - _SNAP_HEADER.size < length:
            raise SnapshotCorrupt(
                f"truncated snapshot payload: header promises {length} "
                f"bytes, {len(data) - _SNAP_HEADER.size} present",
                offset=len(data))
        payload = data[_SNAP_HEADER.size:_SNAP_HEADER.size + length]
        actual = zlib.crc32(payload)
        if actual != crc:
            raise SnapshotCorrupt(
                "snapshot payload checksum mismatch (tampered or "
                "corrupted bytes)", offset=_SNAP_HEADER.size,
                expected_crc=crc, actual_crc=actual)
        snap = pickle.loads(payload)
        if not isinstance(snap, SessionSnapshot):
            raise TypeError(f"not a SessionSnapshot: {type(snap)!r}")
        return snap


class AdvisorSession:
    """A persistent, delta-aware `DesignAdvisor`.

    Usage::

        session = AdvisorSession(workload, AdvisorOptions.dtac())
        rec = session.recommend(budget)           # cold: full build
        session.add_statements([...])
        session.remove_statements(["q07"])
        session.reweight({"q01": 3.0})
        rec = session.recommend(budget)           # delta work only
    """

    def __init__(self, workload: Workload,
                 options: Optional[AdvisorOptions] = None,
                 samples: Optional[SampleManager] = None,
                 sampled_cache: Optional[Dict[Tuple[NodeKey, float],
                                              SizeEstimate]] = None,
                 faults: Optional[FaultInjector] = None):
        workload.by_name()                  # validates name uniqueness
        self.schema = workload.schema
        self.workload = Workload(schema=workload.schema,
                                 statements=list(workload.statements))
        self.opt = options or AdvisorOptions()
        self.device = resolve_device(self.opt.backend, self.opt.device)
        # seeded fault injector or None; sites "apply_delta",
        # "estimation" and "costing" fire HERE (each before any state
        # mutation, so a faulted call is cleanly retryable and the retry
        # is bit-identical), "planner_replay" inside the PlannerEngine
        self.faults = faults
        # SampleManager draws are per-(table, fraction) seed-derived and
        # order-independent, so an outer compressed session hands its
        # manager to successive inner sessions without changing estimates
        self.samples = (samples if samples is not None
                        else SampleManager(self.schema.tables,
                                           seed=self.opt.sample_seed))
        # `sampled_cache` lets sessions share one (NodeKey, f) ->
        # SizeEstimate mapping: estimates are pure in (schema content,
        # sample_seed, NodeKey, f) (see samplecf.schema_fingerprint), so
        # sharing is exact between sessions whose fingerprints match;
        # callers own that grouping
        self.est_engine = EstimationEngine(self.schema.tables, self.samples,
                                           device=self.device)
        self._compressed_mode = self.opt.compression_budget is not None
        # monotone workload version: bumped by every applied delta; keys
        # the peek memos below
        self.workload_version = 0
        self._peeked = None
        self._peeked_est = None
        self._cost_results = None
        if self._compressed_mode:
            # outer mode: keep only O(delta) cluster membership here and
            # delegate the pipeline to an inner session over the derived
            # representative workload (rebuilt on structural change,
            # reweighted in place otherwise)
            self._cluster = ClusterIndex.from_workload(self.workload)
            self._inner: Optional["AdvisorSession"] = None
            self._inner_comp: Optional[CompressedWorkload] = None
            self._pending: List[WorkloadDelta] = []
            self._est_cache: Dict[Tuple[NodeKey, float], SizeEstimate] = (
                self._new_sampled_cache(sampled_cache))
            self._retired: Set[str] = set()
            self.rounds = 0
            self.compression_rebuilds = 0
            self.compression_reweights = 0
            self.compression_bypasses = 0
            return
        self.sizes = SizeProvider(self.schema)
        self.optimizer = WhatIfOptimizer(self.workload, self.sizes,
                                         self.device)
        self.planner = EstimationPlanner(
            self.schema.tables, device=self.device,
            use_engine=self.opt.use_batched_planner, record=True,
            max_nodes=self.opt.max_planner_nodes,
            max_replay=self.opt.max_replay_entries, faults=faults)
        self.engine: Optional[CostEngine] = (
            CostEngine(self.workload, self.sizes, device=self.device)
            if self.opt.use_engine else None)
        # incremental caches
        self._queries: Dict[str, _QueryEntry] = {}
        self._selections: Dict[str, _Selection] = {}
        self._sampled_est: Dict[Tuple[NodeKey, float], SizeEstimate] = (
            self._new_sampled_cache(sampled_cache))
        self._registered: Dict[NodeKey, float] = {}
        # raw candidate key -> [(interned NodeKey, compressed variant)]:
        # reusing the SAME NodeKey objects across rounds turns the
        # planner's dict lookups into identity fast paths
        self._target_cache: Dict[Tuple,
                                 List[Tuple[NodeKey, IndexDef]]] = {}
        self._retired: Set[str] = set()
        # counters (exposed via .stats)
        self.rounds = 0
        self.samplecf_cache_hits = 0
        self.samplecf_cache_misses = 0
        self.selection_hits = 0
        self.selection_misses = 0
        self.cost_prefetch_consumed = 0

    def _new_sampled_cache(self, sampled_cache):
        """The session's (NodeKey, f) SampleCF cache: the caller's shared
        mapping when given, else a bounded LRU when
        `samplecf_cache_entries` asks for one, else a plain dict."""
        if sampled_cache is not None:
            return sampled_cache
        if self.opt.samplecf_cache_entries is not None:
            return EstimateCache(self.opt.samplecf_cache_entries)
        return {}

    # ------------------------------------------------------------------
    # Checkpoint / restore
    # ------------------------------------------------------------------
    def snapshot(self, include_estimates: bool = True) -> SessionSnapshot:
        """Checkpoint the session (the statement list, the retired-name
        set and the warm estimate cache; engines are NOT serialized, they
        are pure in the workload and rebuilt by `restore`).  Pass
        `include_estimates=False` when the estimate cache outlives the
        session anyway; a cold cache only costs recomputation."""
        est = self._est_cache if self._compressed_mode else self._sampled_est
        return SessionSnapshot(
            workload=Workload(schema=self.schema,
                              statements=list(self.workload.statements)),
            options=self.opt,
            workload_version=self.workload_version,
            retired=frozenset(self._retired),
            estimates=dict(est.items()) if include_estimates else {})

    @classmethod
    def restore(cls, snap: SessionSnapshot,
                samples: Optional[SampleManager] = None,
                sampled_cache: Optional[Dict[Tuple[NodeKey, float],
                                             SizeEstimate]] = None,
                faults: Optional[FaultInjector] = None) -> "AdvisorSession":
        """Rebuild a session from a checkpoint.  Its next `recommend` is
        exactly `==` a fresh `DesignAdvisor` on the snapshot workload: the
        constructor rebuilds every engine from the workload, and the
        transplanted estimates are pure in (NodeKey, f), so warming the
        cache only skips recomputation.  `samples` / `sampled_cache`
        re-attach shared state; the snapshot's estimates are merged into a
        shared cache, never replacing it."""
        sess = cls(snap.workload, snap.options, samples=samples,
                   sampled_cache=sampled_cache, faults=faults)
        cache = (sess._est_cache if sess._compressed_mode
                 else sess._sampled_est)
        for k, v in snap.estimates.items():
            if k not in cache:
                cache[k] = v
        sess.workload_version = snap.workload_version
        sess._retired = set(snap.retired)
        return sess

    # ------------------------------------------------------------------
    # Delta API
    # ------------------------------------------------------------------
    def apply(self, delta: WorkloadDelta) -> "AdvisorSession":
        """Apply one mutation batch to the session's workload and every
        long-lived engine.  Statement names are stable ids: a removed name
        is retired for the session's lifetime (re-adding it could alias
        cached candidates of the old statement)."""
        if self.faults is not None:
            # before ANY validation or mutation: a faulted apply leaves
            # the session untouched, so the caller can simply retry it
            self.faults.check("apply_delta")
        for s in delta.added:
            if s.name in self._retired:
                raise ValueError(
                    f"statement name {s.name!r} was removed earlier in "
                    "this session; names are stable ids and cannot be "
                    "reused")
        # apply_delta validates EVERYTHING before any engine is touched,
        # so a bad delta raises here and leaves the session unchanged
        new_wl = self.workload.apply_delta(delta)
        self.workload_version += 1
        self._peeked = None
        self._peeked_est = None
        self._cost_results = None
        if self._compressed_mode:
            # O(delta) cluster-membership maintenance; the inner session
            # catches up at the next recommend()
            self._cluster.apply_delta(delta)
            for name in delta.removed:
                self._retired.add(name)
            self.workload = new_wl
            self._pending.append(delta)
            return self
        if self.engine is not None:
            self.engine.apply_delta(delta)
            self.engine.workload = new_wl
        for name in delta.removed:
            self._retired.add(name)
            self._queries.pop(name, None)
            self._selections.pop(name, None)
        self.workload = new_wl
        # the optimizer prices the new workload; its batched engine, if
        # built, holds the old one and is rebuilt at its next use
        self.optimizer.workload = new_wl
        self.optimizer._engine = None
        return self

    def add_statements(self, statements: Iterable[Statement]
                       ) -> "AdvisorSession":
        return self.apply(WorkloadDelta(added=tuple(statements)))

    def remove_statements(self, names: Iterable[str]) -> "AdvisorSession":
        return self.apply(WorkloadDelta(removed=tuple(names)))

    def reweight(self, weights: Union[Mapping[str, float],
                                      Iterable[Tuple[str, float]]]
                 ) -> "AdvisorSession":
        items = (tuple(weights.items()) if isinstance(weights, Mapping)
                 else tuple(weights))
        return self.apply(WorkloadDelta(reweighted=items))

    # ------------------------------------------------------------------
    # Pipeline stages (each mirrors the DesignAdvisor stage it caches)
    # ------------------------------------------------------------------
    def _query_entry(self, q: Query) -> _QueryEntry:
        e = self._queries.get(q.name)
        if e is None:
            raw = cand.syntactically_relevant(
                q, self.schema.tables[q.table],
                include_clustered=self.opt.include_clustered)
            exp = (cand.expand_with_compression(raw, self.opt.methods)
                   if self.opt.consider_compression else raw)
            e = self._queries[q.name] = _QueryEntry(
                raw, exp, frozenset(i.key for i in exp))
        return e

    def _candidate_universe(self) -> Tuple[Dict[str, List[IndexDef]],
                                           List[IndexDef], List[IndexDef]]:
        """`DesignAdvisor._candidate_universe` over cached per-query lists;
        returns (per-query expanded candidates, expanded merged
        candidates, the raw union in canonical order)."""
        per_query_raw: Dict[str, List[IndexDef]] = {}
        per_query_exp: Dict[str, List[IndexDef]] = {}
        seen: Dict[Tuple, IndexDef] = {}
        for q in self.workload.queries():
            e = self._query_entry(q)
            per_query_raw[q.name] = e.raw
            per_query_exp[q.name] = e.exp
            for idx in e.raw:
                seen.setdefault(idx.key, idx)
        merged = cand.merged_candidates(per_query_raw)
        for idx in merged:
            seen.setdefault(idx.key, idx)
        raw = sorted(seen.values(),
                     key=lambda i: (i.table, i.cols, i.clustered))
        if not self.opt.consider_compression:
            return per_query_exp, merged, raw
        merged_exp = cand.expand_with_compression(merged, self.opt.methods)
        return per_query_exp, merged_exp, raw

    def _estimation_targets(self, raw_union: List[IndexDef]
                            ) -> Dict[NodeKey, List[IndexDef]]:
        """`DesignAdvisor.estimation_targets` over the raw candidate
        union: the (NodeKey, variant) pairs of each raw candidate are
        cached, and the NodeKeys interned, by raw candidate key.  Raw
        candidates in union order yield exactly the target order the
        one-shot advisor derives from the expanded candidate list."""
        out: Dict[NodeKey, List[IndexDef]] = {}
        if not self.opt.consider_compression:
            return out
        tc = self._target_cache
        for idx in raw_union:
            ent = tc.get(idx.key)
            if ent is None:
                if idx.predicate is not None:
                    ent = []
                else:
                    ent = [(NodeKey(idx.table, idx.cols, m),
                            idx.with_compression(m))
                           for m in self.opt.methods]
                tc[idx.key] = ent
            for k, v in ent:
                out.setdefault(k, []).append(v)
        return out

    def _plan_targets(self, raw_union: List[IndexDef]
                      ) -> Tuple[Dict[NodeKey, List[IndexDef]],
                                 Optional[Plan]]:
        """This round's (NodeKey -> variants, estimation Plan) pair: the
        planning half of `_estimate_sizes`."""
        tkey_to_defs = self._estimation_targets(raw_union)
        targets = list(tkey_to_defs)
        if not targets:
            return tkey_to_defs, None
        if self.opt.use_deduction:
            plan = self.planner.plan(targets, self.opt.e, self.opt.q)
        else:
            plan = self.planner.plan_all_sampled(targets, self.opt.e,
                                                 self.opt.q)
        return tkey_to_defs, plan

    def peek_estimation_plan(self) -> Optional[Plan]:
        """Plan this round's size estimation WITHOUT executing it.

        Memoized by `workload_version`: the (candidate universe, target
        map, Plan) triple computed here is reused verbatim by the next
        `recommend()` on the same version.  Returns None in compressed
        (outer) mode, where the representative workload is derived inside
        recommend, and when the round has nothing to estimate."""
        if self._compressed_mode:
            return None
        if self._peeked is not None and \
                self._peeked[0] == self.workload_version:
            return self._peeked[3]
        universe = self._candidate_universe()
        tkey_to_defs, plan = self._plan_targets(universe[2])
        self._peeked = (self.workload_version, universe, tkey_to_defs, plan)
        return plan

    def peek_cost_jobs(self) -> List[Tuple[Query, List[IndexDef]]]:
        """This round's stale per-query costing jobs, NOT scored: the
        (query, expanded candidates) pairs whose selection the next
        `recommend()` would recompute.  Runs the estimation stage once
        (memoized by `workload_version` and consumed verbatim by the next
        `recommend()`) and syncs the engine.  Returns [] in compressed
        (outer) mode and without a cost engine (`use_engine=False`)."""
        if self._compressed_mode or self.engine is None:
            return []
        self.peek_estimation_plan()
        ver, universe, tkey_to_defs, plan = self._peeked
        if self._peeked_est is None or self._peeked_est[0] != ver:
            est = self._estimate_sizes(universe[2], (tkey_to_defs, plan))
            self._peeked_est = (ver, est)
        changed = self._peeked_est[1][4]
        self.engine.sync_sizes()
        jobs: List[Tuple[Query, List[IndexDef]]] = []
        for q in self.workload.queries():
            entry = self._queries[q.name]
            sel = self._selections.get(q.name)
            if sel is None or (changed
                               and not changed.isdisjoint(entry.key_set)):
                jobs.append((q, entry.exp))
        return jobs

    def accept_cost_results(self, version: int,
                            results: Mapping[str, "object"]) -> int:
        """Install prefetched candidate-cost arrays, keyed by query name
        and aligned with the `peek_cost_jobs()` candidate lists, for
        workload `version`.  A stale version is dropped (returns 0).  The
        caller owns the exact-parity contract: each array must hold
        exactly what `engine.candidate_query_costs` would return."""
        if version != self.workload_version:
            return 0
        self._cost_results = (version, dict(results))
        return len(results)

    def _estimate_sizes(self, raw_union: List[IndexDef],
                        planned: Optional[Tuple[Dict[NodeKey,
                                                     List[IndexDef]],
                                                Optional[Plan]]] = None,
                        phases: Optional[Dict[str, float]] = None
                        ) -> Tuple[float, Optional[Plan], int, int,
                                   Set[Tuple]]:
        """`DesignAdvisor.estimate_sizes` with the persistent planner and
        the (NodeKey, f) SampleCF cache.  Returns the usual aggregates
        plus the set of index keys whose registered size CHANGED this
        round (the selection stage's invalidation set).  With `phases`,
        adds the planning and SampleCF wall seconds to it."""
        t0 = time.perf_counter()
        tkey_to_defs, plan = (planned if planned is not None
                              else self._plan_targets(raw_union))
        t1 = time.perf_counter()
        changed: Set[Tuple] = set()
        if plan is None:
            return 0.0, None, 0, 0, changed
        if self.faults is not None:
            # before execute_cached touches the cache: a faulted
            # estimation leaves all caches consistent for the retry
            self.faults.check("estimation")
        # count misses by membership, not by cache growth: a bounded
        # EstimateCache may evict while inserting
        misses = sum(1 for k, n in plan.nodes.items()
                     if n.state is State.SAMPLED
                     and (k, plan.f) not in self._sampled_est)
        ests = self.planner.execute_cached(
            plan, self._sampled_est, self.est_engine,
            scalar=not self.opt.use_batched_estimation)
        self.samplecf_cache_misses += misses
        self.samplecf_cache_hits += plan.n_sampled() - misses
        for k, est in ests.items():
            defs = tkey_to_defs.get(k)
            if not defs:
                continue
            if self._registered.get(k) != est.est_bytes:
                self._registered[k] = est.est_bytes
                changed.update(d.key for d in defs)
            for d in defs:
                self.sizes.register(d, est.est_bytes)
        if phases is not None:
            phases["plan"] += t1 - t0
            phases["samplecf"] += time.perf_counter() - t1
        return (plan.total_cost, plan, plan.n_sampled(), plan.n_deduced(),
                changed)

    # ------------------------------------------------------------------
    def _inner_options(self) -> AdvisorOptions:
        """The inner session's options: the outer's, uncompressed."""
        return dataclasses.replace(self.opt, compression_budget=None)

    def _make_inner(self, workload: Workload) -> "AdvisorSession":
        """A fresh inner session sharing the outer SampleManager, its
        estimation engine (so samples stay on the device across rebuilds)
        and the (NodeKey, f) estimate cache, all order-independent, so
        transplanting them cannot change any estimate."""
        inner = AdvisorSession(workload, self._inner_options(),
                               samples=self.samples, faults=self.faults)
        inner.est_engine = self.est_engine
        self._est_cache.update(inner._sampled_est)
        inner._sampled_est = self._est_cache
        self.compression_rebuilds += 1
        return inner

    def _recommend_compressed(self, budget_bytes: float) -> Recommendation:
        """Outer-mode recommend: derive the budgeted representative
        workload from the incrementally maintained `ClusterIndex`, then
        reuse, reweight or rebuild the inner session.

        Representatives are signature-pure (content-addressed names,
        canonical predicates), so membership churn that keeps the cluster
        set intact only changes representative WEIGHTS: the reweight fast
        path, which keeps every inner engine.  Structural change rebuilds
        the inner session: the compressed statement order is signature-
        sorted, and an in-place append could not reproduce it (float
        summation order is part of the parity contract)."""
        t0 = time.perf_counter()
        self.rounds += 1
        comp = self._cluster.derive(self.opt.compression_budget)
        if comp is None:
            # exact-parity bypass: inner session over the FULL workload
            if self._inner is None or self._inner_comp is not None:
                self._inner = self._make_inner(self.workload)
            else:
                # internal catch-up, not a user-facing apply: suppress the
                # "apply_delta" fault site so a fault can never leave the
                # pending list half-applied (the outer apply() already
                # took its fault check for each delta)
                inner_faults, self._inner.faults = self._inner.faults, None
                try:
                    for d in self._pending:
                        self._inner.apply(d)
                finally:
                    self._inner.faults = inner_faults
            self._inner_comp = None
            self._pending.clear()
            self.compression_bypasses += 1
            rec = self._inner.recommend(budget_bytes)
            return dataclasses.replace(
                rec, wall_seconds=time.perf_counter() - t0)
        cur = (self._inner.workload.statements
               if self._inner is not None and self._inner_comp is not None
               else None)
        new_stmts = comp.workload.statements
        if cur is not None and [s.name for s in cur] == \
                [s.name for s in new_stmts]:
            diffs = {s.name: n.weight for s, n in zip(cur, new_stmts)
                     if s.weight != n.weight}
            if diffs:
                self._inner.reweight(diffs)
            self.compression_reweights += 1
        else:
            self._inner = self._make_inner(comp.workload)
        self._inner_comp = comp
        self._pending.clear()
        t1 = time.perf_counter()
        rec = self._inner.recommend(budget_bytes)
        t2 = time.perf_counter()
        eps = comp.error_bound(rec.config, self._inner.sizes)
        t3 = time.perf_counter()
        phases = dict(rec.phase_seconds, compression=(t1 - t0) + (t3 - t2))
        return dataclasses.replace(
            rec, n_statements_full=comp.n_full,
            n_representatives=comp.n_representatives,
            compression_error_bound=eps,
            compression_error_rel=eps / max(abs(rec.cost), 1e-12),
            wall_seconds=t3 - t0, phase_seconds=phases)

    def recommend(self, budget_bytes: float) -> Recommendation:
        """Re-advise the current workload: identical to
        `DesignAdvisor(current_workload, options).recommend(budget)`, at
        delta-proportional cost."""
        if self._compressed_mode:
            return self._recommend_compressed(budget_bytes)
        phases: Dict[str, float] = {"compression": 0.0, "plan": 0.0,
                                    "samplecf": 0.0}
        t0 = time.perf_counter()
        self.rounds += 1
        base = base_configuration(self.schema)
        peeked = self._peeked
        if peeked is not None and peeked[0] == self.workload_version:
            # reuse the universe + plan peek_estimation_plan() derived for
            # this exact workload version (same inputs, same code path)
            per_query_exp, merged_all, raw_union = peeked[1]
            planned = (peeked[2], peeked[3])
        else:
            per_query_exp, merged_all, raw_union = self._candidate_universe()
            planned = None
        phases["candidates"] = time.perf_counter() - t0
        self._peeked = None
        est_state, self._peeked_est = self._peeked_est, None
        if est_state is not None and est_state[0] == self.workload_version:
            # estimation already ran inside peek_cost_jobs() for this
            # exact workload version (sizes registered, both idempotent)
            est_cost, plan, n_s, n_d, changed = est_state[1]
        else:
            est_cost, plan, n_s, n_d, changed = self._estimate_sizes(
                raw_union, planned, phases)

        if self.faults is not None:
            # size registration above is idempotent, so a fault here is
            # retryable and the retry recommends bit-identically
            self.faults.check("costing")
        t2 = time.perf_counter()
        engine = self.engine
        if engine is not None:
            engine.sync_sizes()
        if changed:
            # the optimizer memoizes statement costs by (statement,
            # config); re-registered sizes invalidate those entries
            self.optimizer._cache.clear()
            if self.optimizer._engine is not None:
                self.optimizer._engine.sync_sizes()
        base_cost = (engine.config_cost(base) if engine is not None
                     else self.optimizer.workload_cost(base))

        pre, self._cost_results = self._cost_results, None
        pre_costs = (pre[1] if pre is not None
                     and pre[0] == self.workload_version else {})
        pool: Dict[Tuple, IndexDef] = {}
        n_cand = 0
        for q in self.workload.queries():
            entry = self._queries[q.name]
            sel = self._selections.get(q.name)
            if sel is None or (changed
                               and not changed.isdisjoint(entry.key_set)):
                pre_q = pre_costs.get(q.name)
                if pre_q is not None:
                    self.cost_prefetch_consumed += 1
                costed = cand.cost_candidates(q, entry.exp, base, self.sizes,
                                              engine, precomputed=pre_q,
                                              optimizer=self.optimizer)
                sel = _Selection(select_candidates(costed, self.opt),
                                 len(costed))
                self._selections[q.name] = sel
                self.selection_misses += 1
            else:
                self.selection_hits += 1
            n_cand += sel.n_costed
            for c in sel.selected:
                pool.setdefault(c.index.key, c.index)
        pool_with_merged(pool, merged_all)
        t3 = time.perf_counter()
        phases["costing"] = t3 - t2

        res = enumerate_pool(self.sizes, self.opt, pool, base, budget_bytes,
                             engine, self.optimizer)
        t4 = time.perf_counter()
        phases["enumeration"] = t4 - t3
        n_full = len(self.workload.statements)
        return Recommendation(
            config=res.config, base=base, base_cost=base_cost, cost=res.cost,
            used_bytes=res.used_bytes, budget_bytes=budget_bytes,
            estimation_cost_pages=est_cost, estimation_plan=plan,
            n_sampled=n_s, n_deduced=n_d, candidate_count=n_cand,
            pool_size=len(pool), wall_seconds=t4 - t0, steps=res.steps,
            phase_seconds=phases, n_statements_full=n_full,
            n_representatives=n_full)

    # ------------------------------------------------------------------
    @property
    def stats(self) -> Dict[str, int]:
        """Incrementality counters (graph / record / replay / selection /
        cache hits): the session's evidence that re-advising cost tracked
        the delta."""
        if self._compressed_mode:
            out = dict(self._inner.stats) if self._inner is not None else {}
            out.update(
                rounds=self.rounds,
                compression_rebuilds=self.compression_rebuilds,
                compression_reweights=self.compression_reweights,
                compression_bypasses=self.compression_bypasses)
            return out
        out = {
            "rounds": self.rounds,
            "selection_hits": self.selection_hits,
            "selection_misses": self.selection_misses,
            "cost_prefetch_consumed": self.cost_prefetch_consumed,
            "samplecf_cache_hits": self.samplecf_cache_hits,
            "samplecf_cache_misses": self.samplecf_cache_misses,
            "sampled_estimates_cached": len(self._sampled_est),
        }
        if isinstance(self._sampled_est, EstimateCache):
            out.update(samplecf_cache_evictions=self._sampled_est.evictions,
                       samplecf_cache_maxsize=self._sampled_est.maxsize)
        if self.engine is not None:
            out.update(engine_rows_added=self.engine.rows_added,
                       engine_rows_removed=self.engine.rows_removed,
                       engine_cols_refreshed=self.engine.cols_refreshed)
        peng = self.planner._engine
        if peng is not None:
            out.update(graph_builds=peng.graph_builds,
                       rec_builds=peng.rec_builds,
                       rec_hits=peng.rec_hits,
                       replay_hits=peng.replay_hits,
                       replay_verified=peng.replay_verified,
                       replay_misses=peng.replay_misses,
                       universe_nodes=len(peng._node_keys),
                       universe_peak_nodes=peng.peak_nodes,
                       universe_evictions=peng.universe_evictions,
                       replay_entries=peng.replay_entries(),
                       replay_evictions=peng.replay_evictions,
                       replay_faults=peng.replay_faults)
        return out
