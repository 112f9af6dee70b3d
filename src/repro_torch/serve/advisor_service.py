"""Multi-tenant advisor fleet service: continuous batching for sessions.

`ServeEngine` multiplexes decode slots over one model; this service
multiplexes request slots over many tenant `AdvisorSession`s.  Each
tenant owns a workload and a stream of requests (workload deltas and
`recommend` calls) submitted through an async-style queue of
Future-backed `FleetTicket`s; the service loop mirrors the repaired
serve-engine step — admit queued requests into free slots, run the
batched shared work, execute each slot, retire — with the same
admission-control surface (`QueueFull` on a bounded queue).

Cross-tenant amortization, the reason a fleet beats N independent
advisors:

* **Shared samples** — tenants are grouped by
  `samplecf.schema_fingerprint` (schema content + sample seed), their
  backend and the device it resolves to; each group owns ONE
  `SampleManager`, so the §4.1 per-(table, f) sampling cost is paid
  once per group, not per tenant.  Sample draws are seed-derived and
  order-independent, which makes the sharing invisible to any single
  tenant.
* **Shared SampleCF cache** — each group owns one (NodeKey, f) ->
  `SizeEstimate` mapping handed to every member session
  (`AdvisorSession(sampled_cache=...)`): an index variant sized for one
  tenant is a cache hit for every other tenant on the same schema.
  With `FleetConfig.cache_entries` the mapping is a bounded LRU
  (`samplecf.EstimateCache`) — eviction only discards recomputable
  state, so long-lived fleets stay bounded without losing parity.
* **Cross-tenant batched prefetch** — before executing a step's slots,
  the service peeks every admitted recommend's estimation plan
  (`AdvisorSession.peek_estimation_plan`, memoized so the peek is free
  at recommend time), unions the group's missing (NodeKey, f) targets,
  and sizes them in one `EstimationEngine.estimate_batch` call per
  (group, f) — many tenants' targets stacked into the engine's grouped
  (ntargets, nrows) codec batches (the codec kernels on the card, their
  plain versions on the CPU, NumPy on the numpy backend).  The group's
  engine runs on the group's device, where its tenants run.
  `estimate_batch` results are
  byte-identical to the scalar `sample_cf` per target, and therefore
  independent of WHICH tenants' targets share a batch — union-batching
  is bit-exact.
* **Cross-tenant batched COST phase** — after the estimation
  prefetch, the service collects every admitted recommend's stale
  (query, candidates) cost jobs (`AdvisorSession.peek_cost_jobs`),
  stacks them per cost-engine device (None for numpy) into padded
  (jobs x candidates) arrays, and evaluates all tenants' candidate costs
  in ONE `batched_candidate_costs` call a device (float32 torch ops on
  the device, one copy each way).  Results are handed back via
  `AdvisorSession.accept_cost_results` (keyed by workload_version so
  stale prefetches are dropped) and consumed verbatim by the slot's
  recommend.  Bit-identical to per-slot costing on both backends:
  against a secondary-free session base every per-candidate cost is
  purely elementwise, so stacking cannot change a single bit.

Durability (the fleet's failure surface, driven by a seeded
`faults.FaultInjector`):

* **Deadlines** — every request carries a deadline in service STEPS
  (never wall-clock, so schedules are deterministic); an expired queued
  request resolves with `TicketTimeout`, except a recommend at the
  head of its tenant's FIFO when `degraded_budget` is set: that one
  DEGRADES instead — it runs immediately at the smaller workload-
  compression budget and returns a `Recommendation` carrying the
  workload-compression error certificate (`ticket.degraded` is True)
  rather than failing.
* **Retries** — a request failing with a transient `FaultError` is
  requeued at the front of the queue (preserving its tenant's FIFO)
  with a deterministic step-based backoff (`retry_backoff`); retries
  are bit-exact because every faulted call fails BEFORE mutating
  session state.
* **Circuit breaker + checkpoint restore** — `quarantine_after`
  consecutive final failures quarantine the tenant: its session is
  dropped, queued tickets resolve with `TenantQuarantined`, submits are
  rejected.  After `quarantine_steps` (or `readmit_tenant`) the tenant
  is restored from its last checkpoint (`AdvisorSession.restore`; a
  snapshot is taken after every successful delta, so the checkpoint
  always equals the tenant's current workload) and its next
  recommendation is exactly `==` a fresh `DesignAdvisor` — the parity
  contract extended to crash recovery.  `crash_tenant` simulates
  process loss.
* **Durable crash recovery** — construct the fleet with
  `store=DurableStore(dir)` and every admitted delta is journaled to
  the tenant's write-ahead log BEFORE it touches the session (a delta
  that then fails to apply is compensated with an ABORT record, so
  replay can never apply it), with the store compacting the WAL into an
  atomically-rotated snapshot manifest when the log suffix exceeds its
  threshold.  After real process death,
  `AdvisorFleetService.recover(dir)` rebuilds the entire fleet — per
  tenant: latest valid snapshot, replay of the WAL suffix — and every
  recovered tenant's next recommendation is exactly `==` a fresh
  `DesignAdvisor` on the recovered workload.  Torn WAL tails are
  truncated at the last valid record; mid-log corruption (e.g. an
  injected `bit_flip`) quarantines only that tenant, on its last valid
  prefix, via the same `TenantQuarantined` path — recovery itself never
  fails the fleet.  Recovery errors are kept in
  `fleet.recovery_errors`, and the store's durability counters
  (`wal_appends`/`fsyncs`/`compactions`/`recoveries`/
  `torn_tail_truncations`) surface through `stats`.

Correctness contract: after any interleaved sequence of per-tenant
deltas and recommends — including injected faults, evictions, timeouts
and crash/restore cycles — each tenant's successful recommendation is
exactly `==` — config, cost, used_bytes — a fresh `DesignAdvisor` built
on that tenant's current workload with the same options, on each
backend.

Budget isolation: every tenant carries a `TenantBudget` — a workload
size cap enforced before any delta is applied, a pending-request cap
enforced at submit time, and an optional per-tenant workload-compression
budget overriding the shared options — so one noisy tenant can neither
starve the queue nor grow without bound.  Request failures (bad deltas,
budget violations) resolve that tenant's ticket with the exception and
leave every other slot untouched.

Counterpart of the JAX package's `serve/advisor_service.py`.  The
reference keys a share group by (fingerprint, estimation backend) but
builds the group's engine on `FleetConfig.backend`; the port's
`AdvisorOptions` has one (backend, device) pair, so a group is keyed by
(fingerprint, backend, resolved device) and its `EstimationEngine` runs
on that device, and `FleetConfig` has no backend: a group's engine runs
where its tenants run, on the card by default and on the CPU only when
their options ask for `device="cpu"`.  The cost phase groups its jobs by
the cost engine's device where the reference groups them by backend.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional, Tuple

import torch

from ..core.advisor import AdvisorOptions
from ..core.backend import resolve_device
from ..core.cost_engine import batched_candidate_costs
from ..core.durability import DurableStore, RecoveredTenant
from ..core.estimation_engine import EstimationEngine
from ..core.estimation_graph import NodeKey, State
from ..core.faults import FaultError, FaultInjector
from ..core.samplecf import (EstimateCache, SampleManager, SizeEstimate,
                             schema_fingerprint)
from ..core.session import AdvisorSession, SessionSnapshot
from ..core.whatif import base_configuration
from ..core.workload import Workload, WorkloadDelta
from .engine import QueueFull


class TenantBudgetExceeded(RuntimeError):
    """A delta would grow a tenant's workload past its budget cap."""


class TicketTimeout(RuntimeError):
    """A request exceeded its deadline (service steps) or a ticket's
    `result()` wait exceeded its wall-clock timeout."""


class TenantQuarantined(RuntimeError):
    """The tenant is quarantined by the circuit breaker: queued tickets
    resolve with this, and new submits are rejected until readmission."""


class SessionLost(RuntimeError):
    """The tenant's session is gone (crashed) and not yet restored."""


class DrainStalled(RuntimeError):
    """`run_until_drained` hit its step budget with work still queued.

    Carries `queued` (total undrained requests) and `pending_by_tenant`
    (tenant id -> queued request count) so callers can see WHO is stuck
    instead of silently losing work."""

    def __init__(self, msg: str, queued: int,
                 pending_by_tenant: Dict[str, int]):
        super().__init__(msg)
        self.queued = queued
        self.pending_by_tenant = dict(pending_by_tenant)


@dataclasses.dataclass
class TenantBudget:
    """Per-tenant isolation limits.

    `max_statements` caps the tenant's workload size — checked against
    the post-delta size BEFORE the delta touches the session, so a
    violating delta fails cleanly and leaves the workload unchanged.
    `max_pending` caps the tenant's queued + in-flight requests at
    submit time (`QueueFull`).  `compression_budget` overrides the
    tenant options' workload-compression budget (outer-mode sessions).
    """
    max_statements: Optional[int] = None
    max_pending: Optional[int] = None
    compression_budget: Optional[int] = None


@dataclasses.dataclass
class FleetConfig:
    slots: int = 8                    # tenant requests executed per step
    max_queue: Optional[int] = None   # global bound; submit raises QueueFull
    prefetch: bool = True             # cross-tenant batched SampleCF prefetch
    # --- durability ---------------------------------------------------
    cache_entries: Optional[int] = None   # bound each group's SampleCF cache
    deadline_steps: Optional[int] = None  # default per-request deadline
    retry_backoff: Tuple[int, ...] = (1, 2, 4)  # step delays; len = retries
    quarantine_after: Optional[int] = 3   # consecutive final failures
    quarantine_steps: Optional[int] = None  # auto-readmit cooldown (steps)
    degraded_budget: Optional[int] = None  # deadline-pressure fallback


class FleetTicket:
    """Future-backed handle for one submitted request.

    `result()` blocks until the service loop retires the request; for a
    recommend it returns the `Recommendation`, for a delta a small
    summary dict.  Failures (invalid delta, `TenantBudgetExceeded`,
    `TicketTimeout`, `TenantQuarantined`) surface through
    `exception()` / a raising `result()`.  `result()` defaults to a
    `DEFAULT_TIMEOUT`-second deadline so a stopped service loop shows
    up as a clear `TicketTimeout` naming the tenant and request kind,
    not a forever-blocked caller; pass an explicit timeout (or None
    via `result(timeout=float("inf"))`) to override."""

    DEFAULT_TIMEOUT: float = 300.0

    def __init__(self, tenant_id: str, kind: str):
        self.tenant_id = tenant_id
        self.kind = kind              # "delta" | "recommend"
        self.submitted_at = time.perf_counter()
        self.resolved_at: Optional[float] = None
        self.degraded = False         # resolved via the degraded path
        self.attempts = 0             # execution attempts (retries + 1)
        self.prefetch_error: Optional[BaseException] = None
        self._future: Future = Future()

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None):
        t = self.DEFAULT_TIMEOUT if timeout is None else timeout
        try:
            return self._future.result(t)
        except FutureTimeout:
            raise TicketTimeout(
                f"tenant {self.tenant_id!r} {self.kind} ticket unresolved "
                f"after {t}s — is the service loop (step() / "
                f"run_until_drained()) still running?") from None

    def exception(self, timeout: Optional[float] = None):
        t = self.DEFAULT_TIMEOUT if timeout is None else timeout
        try:
            return self._future.exception(t)
        except FutureTimeout:
            raise TicketTimeout(
                f"tenant {self.tenant_id!r} {self.kind} ticket unresolved "
                f"after {t}s — is the service loop (step() / "
                f"run_until_drained()) still running?") from None

    @property
    def latency(self) -> Optional[float]:
        """submit -> resolve wall seconds (None while pending)."""
        if self.resolved_at is None:
            return None
        return self.resolved_at - self.submitted_at

    def _resolve(self, value=None, error: Optional[BaseException] = None
                 ) -> None:
        self.resolved_at = time.perf_counter()
        if error is not None:
            self._future.set_exception(error)
        else:
            self._future.set_result(value)


@dataclasses.dataclass
class _FleetRequest:
    tenant_id: str
    kind: str                             # "delta" | "recommend"
    ticket: FleetTicket
    delta: Optional[WorkloadDelta] = None
    budget_bytes: Optional[float] = None
    submitted_step: int = 0               # service step at submit
    deadline_steps: Optional[int] = None  # None: no deadline
    attempts: int = 0                     # failed transient attempts so far
    not_before: int = 0                   # retry backoff: earliest step


class _ShareGroup:
    """One (schema fingerprint, backend, device) equivalence class of
    tenants: a shared order-independent SampleManager, a shared
    (NodeKey, f) SampleCF cache (bounded LRU when the fleet config asks),
    and the batched estimation engine, on the tenants' device, that the
    prefetch stacks the group's targets into."""

    def __init__(self, key: Tuple, tables: Dict, seed: int,
                 device: Optional[torch.device],
                 cache_entries: Optional[int] = None):
        self.key = key
        self.samples = SampleManager(tables, seed=seed)
        self.cache: Dict[Tuple[NodeKey, float], SizeEstimate] = (
            EstimateCache(cache_entries) if cache_entries is not None
            else {})
        self.engine = EstimationEngine(tables, self.samples, device=device)
        self.n_tenants = 0


@dataclasses.dataclass
class _Tenant:
    tenant_id: str
    session: Optional[AdvisorSession]
    budget: TenantBudget
    # None only for a recovered "husk": the durable snapshot itself was
    # unreadable, so there is no schema to attach a share group to
    group: Optional[_ShareGroup]
    snapshot: Optional[SessionSnapshot] = None  # last good checkpoint
    in_flight: Optional[_FleetRequest] = None
    n_pending: int = 0                # queued + in-flight requests
    deltas_applied: int = 0
    recommends: int = 0
    consecutive_failures: int = 0     # final (post-retry) failures in a row
    quarantined_at: Optional[int] = None  # step of quarantine, None: healthy
    quarantines: int = 0
    restores: int = 0


class AdvisorFleetService:
    """Slot-based continuous batching over many tenant AdvisorSessions.

    Usage::

        fleet = AdvisorFleetService(FleetConfig(slots=16))
        fleet.register_tenant("t0", workload0, options)
        fleet.register_tenant("t1", workload1, options)   # same schema:
                                                          # shares samples
        fleet.submit_delta("t0", WorkloadDelta(added=(...,)))
        t = fleet.submit_recommend("t0", budget_bytes=2e6)
        fleet.run_until_drained()
        rec = t.result()          # == fresh DesignAdvisor on t0's workload
    """

    def __init__(self, fc: Optional[FleetConfig] = None,
                 faults: Optional[FaultInjector] = None,
                 store: Optional[DurableStore] = None):
        self.fc = fc or FleetConfig()
        if self.fc.slots < 1:
            raise ValueError("need at least one slot")
        # one injector threads the whole stack: sessions check
        # "apply_delta"/"estimation"/"costing" (and their planners
        # "planner_replay"); the service itself checks "prefetch"; the
        # durable store checks "disk_write"/"fsync"/"bit_flip"
        self.faults = faults
        self.store = store
        if store is not None and store.faults is None:
            store.faults = faults
        # tenant id -> the exception that degraded its recovery (mid-log
        # corruption, unreadable snapshot, replay failure); such tenants
        # come back quarantined on their last valid durable prefix
        self.recovery_errors: Dict[str, BaseException] = {}
        self.tenants: Dict[str, _Tenant] = {}
        self.groups: Dict[Tuple, _ShareGroup] = {}
        self.queue: List[_FleetRequest] = []          # global arrival order
        self.slots: List[Optional[_FleetRequest]] = [None] * self.fc.slots
        self.steps = 0
        self.retired = 0
        self.prefetch_batches = 0     # (group, f) batched prefetch calls
        self.prefetch_targets = 0     # targets sized by the prefetch
        self.prefetch_hits = 0        # peeked targets already cached
        self.prefetch_failures = 0    # peeks/batches that raised
        self.cost_prefetch_batches = 0  # cross-tenant stacked COST batches
        self.cost_prefetch_jobs = 0     # (tenant, query) jobs so scored
        self.retries = 0              # transient failures requeued
        self.timeouts = 0             # requests expired by their deadline
        self.degraded_recommends = 0  # deadline recommends served degraded
        self.failures = 0             # final (post-retry) request failures
        self.quarantines = 0
        self.restores = 0
        self.restore_seconds: List[float] = []  # per-restore wall time

    # ------------------------------------------------------------------
    # Tenants
    # ------------------------------------------------------------------
    def register_tenant(self, tenant_id: str, workload: Workload,
                        options: Optional[AdvisorOptions] = None,
                        budget: Optional[TenantBudget] = None) -> None:
        if tenant_id in self.tenants:
            raise ValueError(f"tenant {tenant_id!r} already registered")
        opt = options or AdvisorOptions()
        budget = budget or TenantBudget()
        if budget.compression_budget is not None:
            opt = dataclasses.replace(
                opt, compression_budget=budget.compression_budget)
        if budget.max_statements is not None and \
                len(workload.statements) > budget.max_statements:
            raise TenantBudgetExceeded(
                f"tenant {tenant_id!r}: initial workload of "
                f"{len(workload.statements)} statements exceeds "
                f"max_statements={budget.max_statements}")
        group = self._group_for(workload.schema, opt)
        group.n_tenants += 1
        session = AdvisorSession(workload, opt, samples=group.samples,
                                 sampled_cache=group.cache,
                                 faults=self.faults)
        t = _Tenant(tenant_id, session, budget, group)
        # checkpoint from birth: a tenant crashing before its first
        # successful delta still restores to its registered workload.
        # Estimates are excluded — restore re-attaches the share-group
        # cache, which survives the session (copying it per tenant per
        # checkpoint would duplicate the whole shared cache).
        t.snapshot = session.snapshot(include_estimates=False)
        if self.store is not None:
            self.store.register(tenant_id, t.snapshot.to_bytes(),
                                meta=budget)
        self.tenants[tenant_id] = t

    def _group_for(self, schema, opt: AdvisorOptions) -> _ShareGroup:
        """The tenant's share group — one per (schema fingerprint,
        backend, device), created on first use."""
        device = resolve_device(opt.backend, opt.device)
        key = (schema_fingerprint(schema, opt.sample_seed), opt.backend,
               device)
        group = self.groups.get(key)
        if group is None:
            group = self.groups[key] = _ShareGroup(
                key, schema.tables, opt.sample_seed, device,
                self.fc.cache_entries)
        return group

    def crash_tenant(self, tenant_id: str) -> None:
        """Simulate process loss of one tenant's session: the session is
        dropped and the tenant quarantined (queued tickets resolve with
        `TenantQuarantined`).  Recovery is the normal readmission path —
        checkpoint restore via `readmit_tenant` or the
        `quarantine_steps` cooldown."""
        t = self.tenants[tenant_id]
        if t.quarantined_at is None:
            self._quarantine(t, "session crashed (injected)")

    def readmit_tenant(self, tenant_id: str) -> None:
        """Restore a quarantined tenant from its last checkpoint.  The
        restored session re-attaches the share group's SampleManager and
        SampleCF cache; its next recommendation is exactly `==` a fresh
        `DesignAdvisor` on the checkpoint workload."""
        t = self.tenants[tenant_id]
        if t.quarantined_at is None:
            raise ValueError(f"tenant {tenant_id!r} is not quarantined")
        if t.snapshot is None or t.group is None:
            raise SessionLost(
                f"tenant {tenant_id!r} has no restorable checkpoint "
                "(its durable snapshot was unreadable at recovery); "
                "re-register it with a fresh workload")
        t0 = time.perf_counter()
        t.session = AdvisorSession.restore(
            t.snapshot, samples=t.group.samples,
            sampled_cache=t.group.cache, faults=self.faults)
        self.restore_seconds.append(time.perf_counter() - t0)
        if self.store is not None:
            # realign the durable state with the checkpoint we just
            # restored to: a corrupt/poisoned WAL suffix must not be
            # replayed on top of it at the next recovery
            self.store.checkpoint(tenant_id, t.snapshot.to_bytes(),
                                  meta=t.budget)
        self.recovery_errors.pop(tenant_id, None)
        t.quarantined_at = None
        t.consecutive_failures = 0
        t.restores += 1
        self.restores += 1

    # ------------------------------------------------------------------
    # Durable recovery (after real process death)
    # ------------------------------------------------------------------
    @classmethod
    def recover(cls, store_or_dir,
                fc: Optional[FleetConfig] = None,
                faults: Optional[FaultInjector] = None
                ) -> "AdvisorFleetService":
        """Rebuild a fleet from a durable store directory: per tenant,
        restore the latest valid snapshot manifest and replay the WAL
        suffix of journaled-but-uncheckpointed deltas.  Every cleanly
        recovered tenant's next recommendation is exactly `==` a fresh
        `DesignAdvisor` on the recovered workload.  Degraded tenants —
        mid-log corruption, unreadable snapshot, a replay failure —
        come back QUARANTINED on their last valid durable prefix
        (`recovery_errors[tenant_id]` holds why) instead of failing the
        fleet; `readmit_tenant` restores them from that prefix."""
        store = (store_or_dir if isinstance(store_or_dir, DurableStore)
                 else DurableStore(store_or_dir))
        fleet = cls(fc=fc, faults=faults, store=store)
        recovered = store.recover()
        for tid in sorted(recovered):
            fleet._recover_tenant(recovered[tid])
        return fleet

    def _recover_tenant(self, rt: RecoveredTenant) -> None:
        tid = rt.tenant_id
        budget = (rt.meta if isinstance(rt.meta, TenantBudget)
                  else TenantBudget())
        error: Optional[BaseException] = rt.error
        snap: Optional[SessionSnapshot] = None
        if rt.snapshot_bytes is not None:
            try:
                snap = SessionSnapshot.from_bytes(rt.snapshot_bytes)
            except Exception as e:
                error = error or e
        if snap is None:
            # unrecoverable husk: with no readable snapshot there is no
            # schema, no share group, nothing to replay onto — keep the
            # tenant visible (quarantined, submits rejected) so the
            # loss is observable rather than silent
            t = _Tenant(tid, None, budget, None)
            self.tenants[tid] = t
            err = error or SessionLost(
                f"tenant {tid!r}: no readable durable snapshot")
            self.recovery_errors[tid] = err
            self._quarantine(t, f"recovery failed: {err}")
            return
        t0 = time.perf_counter()
        group = self._group_for(snap.workload.schema, snap.options)
        session: Optional[AdvisorSession] = None
        try:
            # replay with fault injection OFF: recovery re-applies
            # already-admitted work, and a storm firing mid-replay would
            # turn deterministic history into a coin flip
            session = AdvisorSession.restore(
                snap, samples=group.samples, sampled_cache=group.cache,
                faults=None)
            for delta in rt.deltas:
                try:
                    session.apply(delta)
                except Exception as e:
                    # almost always the final record: a delta journaled
                    # by the write-ahead rule but never validated by an
                    # apply before the crash.  Keep the state up to it.
                    error = error or e
                    break
        except Exception as e:
            error = error or e
        self.restore_seconds.append(time.perf_counter() - t0)
        if session is None:
            t = _Tenant(tid, None, budget, None)
            self.tenants[tid] = t
            self.recovery_errors[tid] = error
            self._quarantine(t, f"recovery failed: {error}")
            return
        group.n_tenants += 1
        t = _Tenant(tid, session, budget, group)
        t.snapshot = session.snapshot(include_estimates=False)
        self.tenants[tid] = t
        if error is not None:
            self.recovery_errors[tid] = error
            # the durable log is poisoned past this prefix — realign it
            # with the recovered state so the next crash replays cleanly
            self.store.checkpoint(tid, t.snapshot.to_bytes(), meta=budget)
            self._quarantine(t, f"recovery degraded: {error}")
            return
        session.faults = self.faults

    # ------------------------------------------------------------------
    # Submission (admission control)
    # ------------------------------------------------------------------
    def _submit(self, req: _FleetRequest,
                deadline_steps: Optional[int]) -> FleetTicket:
        t = self.tenants[req.tenant_id]
        if t.quarantined_at is not None:
            raise TenantQuarantined(
                f"tenant {req.tenant_id!r} is quarantined (since step "
                f"{t.quarantined_at}); readmit_tenant() or wait for the "
                "cooldown")
        if self.fc.max_queue is not None and \
                len(self.queue) >= self.fc.max_queue:
            raise QueueFull(
                f"fleet queue at capacity ({self.fc.max_queue})")
        if t.budget.max_pending is not None and \
                t.n_pending >= t.budget.max_pending:
            raise QueueFull(
                f"tenant {req.tenant_id!r} at max_pending="
                f"{t.budget.max_pending}")
        req.submitted_step = self.steps
        req.deadline_steps = (deadline_steps if deadline_steps is not None
                              else self.fc.deadline_steps)
        t.n_pending += 1
        self.queue.append(req)
        return req.ticket

    def submit_delta(self, tenant_id: str, delta: WorkloadDelta,
                     deadline_steps: Optional[int] = None) -> FleetTicket:
        return self._submit(_FleetRequest(
            tenant_id, "delta", FleetTicket(tenant_id, "delta"),
            delta=delta), deadline_steps)

    def submit_recommend(self, tenant_id: str, budget_bytes: float,
                         deadline_steps: Optional[int] = None
                         ) -> FleetTicket:
        return self._submit(_FleetRequest(
            tenant_id, "recommend", FleetTicket(tenant_id, "recommend"),
            budget_bytes=float(budget_bytes)), deadline_steps)

    # ------------------------------------------------------------------
    # Service loop (mirrors ServeEngine: admit -> batch -> execute ->
    # retire)
    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Fill free slots from the queue in arrival order, at most one
        in-flight request per tenant so each tenant's requests execute
        in its own submission order (per-tenant FIFO).  Requests backing
        off after a transient failure (`not_before`) are skipped until
        their step comes up — and BLOCK their tenant's later requests
        meanwhile, or the backoff would reorder that tenant's stream."""
        for i in range(len(self.slots)):
            if self.slots[i] is not None:
                continue
            blocked = {tid for tid, t in self.tenants.items()
                       if t.in_flight is not None}
            for qi, req in enumerate(self.queue):
                if req.tenant_id in blocked:
                    continue
                if req.not_before > self.steps:
                    blocked.add(req.tenant_id)
                    continue
                self.queue.pop(qi)
                self.slots[i] = req
                self.tenants[req.tenant_id].in_flight = req
                break
            else:
                break  # nothing admissible for this (or any later) slot

    def _expire(self) -> None:
        """Resolve queued requests that outlived their deadline.

        Deadlines are measured in service STEPS since submission (the
        retry backoff shares the clock), so expiry is deterministic.  An
        expired recommend at the head of its tenant's FIFO degrades when
        `degraded_budget` is configured; everything else resolves with
        `TicketTimeout`."""
        if not any(r.deadline_steps is not None for r in self.queue):
            return
        kept: List[_FleetRequest] = []
        has_earlier = set()   # tenants with a surviving earlier request
        for req in self.queue:
            dl = req.deadline_steps
            waited = self.steps - req.submitted_step
            if dl is None or waited < dl:
                kept.append(req)
                has_earlier.add(req.tenant_id)
                continue
            t = self.tenants[req.tenant_id]
            if (req.kind == "recommend"
                    and self.fc.degraded_budget is not None
                    and req.tenant_id not in has_earlier
                    and t.session is not None):
                self._execute_degraded(req, t)
            else:
                req.ticket._resolve(error=TicketTimeout(
                    f"tenant {req.tenant_id!r} {req.kind} request "
                    f"exceeded its deadline of {dl} service steps "
                    f"(waited {waited})"))
                self.timeouts += 1
            t.n_pending -= 1
            self.retired += 1
        self.queue = kept

    def _execute_degraded(self, req: _FleetRequest, t: _Tenant) -> None:
        """Deadline-pressure fallback: serve the recommend NOW from a
        one-shot session at the smaller `degraded_budget` workload-
        compression budget.  The result is exact for that budget (`==` a
        fresh DesignAdvisor with the same option) and carries the
        workload-compression error certificate quantifying the
        approximation to the full-budget answer; `ticket.degraded` marks
        it."""
        assert t.session is not None and req.budget_bytes is not None
        try:
            opt = dataclasses.replace(
                t.session.opt, compression_budget=self.fc.degraded_budget)
            deg = AdvisorSession(t.session.workload, opt,
                                 samples=t.group.samples,
                                 sampled_cache=t.group.cache)
            rec = deg.recommend(req.budget_bytes)
            req.ticket.degraded = True
            t.recommends += 1
            t.consecutive_failures = 0
            self.degraded_recommends += 1
            req.ticket._resolve(rec)
        except BaseException as e:
            self._final_failure(req, t, e)

    def _prefetch(self) -> None:
        """Union-batch the admitted recommends' missing SampleCF targets.

        For every admitted recommend, peek the tenant's estimation plan
        (memoized — the subsequent recommend reuses it verbatim), take
        its SAMPLED nodes not yet in the group cache, and size each
        (group, f) union in ONE `estimate_batch` call.  Per-target
        results are byte-identical to the scalar path, so cache content
        does not depend on which tenants were batched together.

        A failed peek or batch is counted in `prefetch_failures` and
        attached to the affected tickets (`ticket.prefetch_error`) —
        never swallowed silently.  It is NOT fatal: the prefetch is a
        pure warm-up, so the slot's recommend recomputes (or re-raises,
        for session faults) on its own."""
        missing: Dict[Tuple[Tuple, float], List[NodeKey]] = {}
        seen: Dict[Tuple[Tuple, float], set] = {}
        contributors: Dict[Tuple[Tuple, float], List[FleetTicket]] = {}
        for req in self.slots:
            if req is None or req.kind != "recommend":
                continue
            t = self.tenants[req.tenant_id]
            if t.session is None:
                continue
            try:
                plan = t.session.peek_estimation_plan()
            except Exception as e:
                self.prefetch_failures += 1
                req.ticket.prefetch_error = e
                continue  # the slot's recommend surfaces/retries it
            if plan is None:
                continue
            gk = (t.group.key, plan.f)
            contributors.setdefault(gk, []).append(req.ticket)
            got = seen.setdefault(gk, set())
            for k, node in plan.nodes.items():
                if node.state is not State.SAMPLED or k in got:
                    continue
                got.add(k)
                if (k, plan.f) in t.group.cache:
                    self.prefetch_hits += 1
                else:
                    missing.setdefault(gk, []).append(k)
        for (group_key, f), keys in missing.items():
            group = self.groups[group_key]
            try:
                if self.faults is not None:
                    self.faults.check(
                        "prefetch", f"batch of {len(keys)} at f={f}")
                ests = group.engine.estimate_batch(keys, f)
            except Exception as e:
                self.prefetch_failures += 1
                for tk in contributors.get((group_key, f), ()):
                    tk.prefetch_error = e
                continue  # recommends fall back to per-session estimation
            for k, est in ests.items():
                group.cache[(k, f)] = est
            self.prefetch_batches += 1
            self.prefetch_targets += len(keys)

    def _cost_prefetch(self) -> None:
        """Stack the admitted recommends' stale per-query costing jobs
        into cross-tenant (tenant x statement x candidate) batches, one
        per cost-engine device (None: numpy) — the fleet COST phase.

        Each tenant's `peek_cost_jobs()` runs its estimation stage once
        (memoized by workload version; the slot's recommend reuses it
        verbatim) and exposes the queries whose §6.1 selections need
        re-costing; `batched_candidate_costs` then scores every tenant's
        jobs in one stacked pass with exactly the per-job arithmetic
        (bitwise on numpy and on torch: the same float32 op sequence), and
        results flow back through `accept_cost_results`, keyed by
        workload version so a stale batch is simply dropped.  Like
        `_prefetch`, a failure is counted and attached to the ticket but
        never fatal — the recommend recomputes on its own."""
        by_device: Dict[Optional[torch.device], List] = {}
        for req in self.slots:
            if req is None or req.kind != "recommend":
                continue
            t = self.tenants[req.tenant_id]
            s = t.session
            if s is None:
                continue
            try:
                jobs = s.peek_cost_jobs()
                if not jobs:
                    continue
                base = base_configuration(s.schema)
                rows = [(q.name, s.engine.cost_job_arrays(q, base, cands))
                        for q, cands in jobs]
            except Exception as e:
                self.prefetch_failures += 1
                req.ticket.prefetch_error = e
                continue  # the slot's recommend surfaces/retries it
            by_device.setdefault(s.engine.device, []).append(
                (s, s.workload_version, rows, req.ticket))
        for device, entries in by_device.items():
            flat = [arrays for (_, _, rows, _) in entries
                    for (_, arrays) in rows]
            try:
                costs = batched_candidate_costs(flat, device=device)
            except Exception as e:
                self.prefetch_failures += 1
                for (_, _, _, tk) in entries:
                    tk.prefetch_error = e
                continue
            k = 0
            for s, ver, rows, _ in entries:
                res = {}
                for qname, arrays in rows:
                    res[qname] = costs[k, :len(arrays["cov"])]
                    k += 1
                s.accept_cost_results(ver, res)
                self.cost_prefetch_jobs += len(rows)
            self.cost_prefetch_batches += 1

    def _final_failure(self, req: _FleetRequest, t: _Tenant,
                       e: BaseException) -> None:
        """Resolve a request with its (post-retry) error and feed the
        tenant's circuit breaker."""
        req.ticket._resolve(error=e)
        t.consecutive_failures += 1
        self.failures += 1
        if (t.quarantined_at is None
                and self.fc.quarantine_after is not None
                and t.consecutive_failures >= self.fc.quarantine_after):
            self._quarantine(
                t, f"{t.consecutive_failures} consecutive failures "
                f"(last: {type(e).__name__}: {e})")

    def _quarantine(self, t: _Tenant, reason: str) -> None:
        """Circuit breaker: isolate the tenant from its share group —
        drop the (possibly poisoned) session, flush its queued requests
        with `TenantQuarantined`, reject new submits — until checkpoint
        restore readmits it."""
        t.quarantined_at = self.steps
        t.quarantines += 1
        self.quarantines += 1
        t.session = None
        mine = [r for r in self.queue if r.tenant_id == t.tenant_id]
        self.queue = [r for r in self.queue if r.tenant_id != t.tenant_id]
        for r in mine:
            r.ticket._resolve(error=TenantQuarantined(
                f"tenant {t.tenant_id!r} quarantined at step "
                f"{t.quarantined_at}: {reason}"))
            t.n_pending -= 1
            self.retired += 1

    def _execute(self, req: _FleetRequest) -> bool:
        """Run one slot's request.  Returns True when the request is
        retired (resolved either way), False when it was requeued for a
        deterministic-backoff retry after a transient `FaultError`."""
        t = self.tenants[req.tenant_id]
        req.attempts += 1
        req.ticket.attempts = req.attempts
        try:
            if t.session is None:
                raise SessionLost(
                    f"tenant {req.tenant_id!r} has no live session")
            if req.kind == "delta":
                assert req.delta is not None
                cap = t.budget.max_statements
                if cap is not None:
                    projected = (len(t.session.workload.statements)
                                 + len(req.delta.added)
                                 - len(req.delta.removed))
                    if projected > cap:
                        raise TenantBudgetExceeded(
                            f"tenant {req.tenant_id!r}: delta would grow "
                            f"the workload to {projected} statements "
                            f"(max_statements={cap})")
                if self.store is None:
                    t.session.apply(req.delta)
                else:
                    # write-ahead: journal the admitted delta BEFORE it
                    # touches the session.  A failed apply is
                    # compensated with an ABORT record so recovery can
                    # never replay a delta the live fleet rejected.
                    seq = self.store.log_delta(req.tenant_id, req.delta)
                    try:
                        t.session.apply(req.delta)
                    except BaseException:
                        self.store.log_abort(req.tenant_id, seq)
                        raise
                t.deltas_applied += 1
                # checkpoint AFTER every successful delta: the snapshot
                # always equals the live workload (failed deltas never
                # mutate), so a later crash restores to current state
                t.snapshot = t.session.snapshot(include_estimates=False)
                if self.store is not None:
                    self.store.maybe_compact(
                        req.tenant_id, t.snapshot.to_bytes,
                        meta=t.budget)
                t.consecutive_failures = 0
                req.ticket._resolve({
                    "applied": True,
                    "workload_version": t.session.workload_version,
                    "n_statements": len(t.session.workload.statements)})
            else:
                assert req.budget_bytes is not None
                rec = t.session.recommend(req.budget_bytes)
                t.recommends += 1
                t.consecutive_failures = 0
                req.ticket._resolve(rec)
        except BaseException as e:      # isolate failures to this tenant
            if isinstance(e, FaultError) and \
                    req.attempts <= len(self.fc.retry_backoff):
                # transient: requeue at the FRONT (this is the tenant's
                # oldest request, so front-insertion preserves both its
                # own FIFO and fairness to other tenants' older work)
                req.not_before = (self.steps + 1
                                  + self.fc.retry_backoff[req.attempts - 1])
                self.queue.insert(0, req)
                self.retries += 1
                return False
            self._final_failure(req, t, e)
        return True

    def step(self) -> None:
        """One service iteration: readmit cooled-down tenants, expire
        overdue requests, admit queued requests into free slots, run the
        cross-tenant batched prefetch over the admitted recommends,
        execute every slot, retire (a request is one unit of work, so
        slots turn over every step).  `steps` advances every call —
        also on idle ticks — because the retry backoff and quarantine
        cooldown measure time in steps."""
        if self.fc.quarantine_steps is not None:
            for t in self.tenants.values():
                if t.quarantined_at is not None and \
                        self.steps - t.quarantined_at >= \
                        self.fc.quarantine_steps:
                    self.readmit_tenant(t.tenant_id)
        self._expire()
        self._admit()
        if any(s is not None for s in self.slots):
            if self.fc.prefetch:
                self._prefetch()
                self._cost_prefetch()
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                retired = self._execute(req)
                t = self.tenants[req.tenant_id]
                t.in_flight = None
                self.slots[i] = None
                if retired:
                    t.n_pending -= 1
                    self.retired += 1
        self.steps += 1

    def run_until_drained(self, max_steps: int = 1_000_000) -> None:
        """Step until the queue is empty, or raise `DrainStalled` after
        `max_steps` steps THIS CALL (never silently return with work
        still queued)."""
        for _ in range(max_steps):
            if not self.queue:
                return
            self.step()
        if self.queue:
            pending: Dict[str, int] = {}
            for r in self.queue:
                pending[r.tenant_id] = pending.get(r.tenant_id, 0) + 1
            raise DrainStalled(
                f"drain stalled after {max_steps} steps with "
                f"{len(self.queue)} requests queued "
                f"(per tenant: {pending})", len(self.queue), pending)

    # ------------------------------------------------------------------
    @property
    def stats(self) -> Dict[str, float]:
        out = {
            "tenants": len(self.tenants),
            "groups": len(self.groups),
            "queued": len(self.queue),
            "steps": self.steps,
            "retired": self.retired,
            "prefetch_batches": self.prefetch_batches,
            "prefetch_targets": self.prefetch_targets,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_failures": self.prefetch_failures,
            "cost_prefetch_batches": self.cost_prefetch_batches,
            "cost_prefetch_jobs": self.cost_prefetch_jobs,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "degraded_recommends": self.degraded_recommends,
            "failures": self.failures,
            "quarantines": self.quarantines,
            "restores": self.restores,
            "quarantined_tenants": sum(
                1 for t in self.tenants.values()
                if t.quarantined_at is not None),
        }
        # durability counters (all zero for a store-less fleet)
        ds = self.store.stats() if self.store is not None else {}
        for k in ("wal_appends", "wal_aborts", "fsyncs", "compactions",
                  "recoveries", "torn_tail_truncations"):
            out[k] = ds.get(k, 0)
        out["recovery_errors"] = len(self.recovery_errors)
        out["shared_cache_entries"] = sum(
            len(g.cache) for g in self.groups.values())
        out["shared_cache_evictions"] = sum(
            g.cache.evictions for g in self.groups.values()
            if isinstance(g.cache, EstimateCache))
        out["sampling_calls"] = sum(
            g.samples.sampling_calls for g in self.groups.values())
        return out

    def tenant_stats(self, tenant_id: str) -> Dict[str, float]:
        t = self.tenants[tenant_id]
        out = dict(t.session.stats) if t.session is not None else {}
        out.update(deltas_applied=t.deltas_applied,
                   recommends=t.recommends,
                   consecutive_failures=t.consecutive_failures,
                   quarantined=t.quarantined_at is not None,
                   quarantines=t.quarantines,
                   restores=t.restores,
                   group_tenants=(t.group.n_tenants
                                  if t.group is not None else 0))
        if t.session is not None:
            out["n_statements"] = len(t.session.workload.statements)
        return out
