"""The port's fleet advisor service: multi-tenant continuous batching
invariants (the twin of tests/test_fleet_service.py, with
tests/test_backend_unified.py's stacked cost batch and fleet cost
prefetch).

The load-bearing assertion is exact parity: whatever the interleaving of
tenant deltas and recommends through the shared slots, every tenant's
recommendation equals (config, cost, used_bytes) a fresh `DesignAdvisor`
with the same options on that tenant's current workload.  The rest pins
the amortization machinery (share groups keyed by schema fingerprint,
backend and device; the shared SampleCF cache; the cross-tenant prefetch
and the stacked cost phase) and the isolation surface (admission
control, per-tenant budgets, failure containment).  Every fleet test
runs on the numpy backend and on the torch backend on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (AdvisorOptions, CostEngine, DesignAdvisor,
                              DurableStore, FaultError, FaultInjector,
                              FaultSpec, WorkloadDelta, base_configuration,
                              make_scaled_workload, make_tpch_like,
                              make_tpch_workload)
from repro_torch.core import candidates as cand
from repro_torch.core.cost_engine import batched_candidate_costs
from repro_torch.core.samplecf import schema_fingerprint
from repro_torch.serve.advisor_service import (AdvisorFleetService,
                                               DrainStalled, FleetConfig,
                                               TenantBudget,
                                               TenantBudgetExceeded,
                                               TenantQuarantined,
                                               TicketTimeout)
from repro_torch.serve.engine import QueueFull

BACKENDS = ["numpy", "torch"]
BUDGET = 2_000_000


def tenant_workload(schema, tid: str, n: int = 14, seed: int = 0):
    """A per-tenant workload with tenant-prefixed statement names."""
    wl = make_scaled_workload(schema, n_statements=n, seed=seed)
    return dataclasses.replace(
        wl, statements=[dataclasses.replace(s, name=f"{tid}_{s.name}")
                        for s in wl.statements])


def identical(a, b) -> bool:
    return (a.config == b.config and a.cost == b.cost
            and a.used_bytes == b.used_bytes)


@pytest.fixture(scope="module")
def schema():
    return make_tpch_like(scale=0.1, seed=0)


@pytest.fixture(params=BACKENDS)
def opt(request):
    return AdvisorOptions(backend=request.param, device="cpu")


def make_fleet(schema, n_tenants, opt, fc=None):
    fleet = AdvisorFleetService(fc or FleetConfig(slots=3))
    wls = {}
    for i in range(n_tenants):
        tid = f"t{i}"
        wls[tid] = tenant_workload(schema, tid, seed=50 + i)
        fleet.register_tenant(tid, wls[tid], opt)
    return fleet, wls


class TestFleetParity:
    def test_batched_recommends_match_fresh_advisor(self, schema, opt):
        fleet, wls = make_fleet(schema, 5, opt)
        tickets = {tid: fleet.submit_recommend(tid, BUDGET) for tid in wls}
        fleet.run_until_drained()
        for tid, tk in tickets.items():
            fresh = DesignAdvisor(wls[tid], opt).recommend(BUDGET)
            assert identical(tk.result(), fresh), tid
        assert fleet.stats["groups"] == 1  # same schema: one share group

    def test_interleaved_delta_storm_parity(self, schema, opt):
        """THE fleet contract: exact per-tenant parity under interleaved
        per-tenant deltas and recommends sharing slots and caches."""
        fleet, wls = make_fleet(schema, 4, opt)
        rng = np.random.default_rng(3)
        for rnd in range(3):
            tks = {}
            for i, tid in enumerate(list(wls)):
                wl = wls[tid]
                names = [s.name for s in wl.statements]
                removed = tuple(rng.choice(names, size=2, replace=False))
                pool = make_scaled_workload(
                    schema, n_statements=2,
                    seed=900 + rnd * 10 + i).statements
                added = tuple(
                    dataclasses.replace(s, name=f"{tid}_r{rnd}_{j}")
                    for j, s in enumerate(pool))
                rw = tuple((n, float(rng.uniform(0.5, 2.0)))
                           for n in rng.choice(
                               [n for n in names if n not in removed],
                               size=3, replace=False))
                delta = WorkloadDelta(added=added, removed=removed,
                                      reweighted=rw)
                fleet.submit_delta(tid, delta)
                wls[tid] = wl.apply_delta(delta)
                tks[tid] = fleet.submit_recommend(tid, BUDGET)
            fleet.run_until_drained()
            for tid, tk in tks.items():
                fresh = DesignAdvisor(wls[tid], opt).recommend(BUDGET)
                assert identical(tk.result(), fresh), (rnd, tid)

    def test_per_tenant_fifo(self, schema, opt):
        """A tenant's requests execute in its submission order: a
        recommend submitted after a delta sees the post-delta workload
        even though both were queued before the loop ran."""
        fleet, wls = make_fleet(schema, 1, opt)
        wl = wls["t0"]
        delta = WorkloadDelta(
            removed=(wl.statements[0].name, wl.statements[1].name))
        fleet.submit_delta("t0", delta)
        tk = fleet.submit_recommend("t0", BUDGET)
        fleet.run_until_drained()
        fresh = DesignAdvisor(wl.apply_delta(delta), opt).recommend(BUDGET)
        assert identical(tk.result(), fresh)


class TestSharing:
    def test_fingerprint_grouping(self, schema, opt):
        """Tenants group by schema CONTENT + seed, not by object
        identity; different content lands in different groups."""
        other = make_tpch_like(scale=0.1, seed=1)
        assert schema_fingerprint(schema, 0) == \
            schema_fingerprint(make_tpch_like(scale=0.1, seed=0), 0)
        assert schema_fingerprint(schema, 0) != schema_fingerprint(other, 0)
        assert schema_fingerprint(schema, 0) != schema_fingerprint(schema, 1)

        fleet = AdvisorFleetService(FleetConfig(slots=2))
        fleet.register_tenant("a", tenant_workload(schema, "a"), opt)
        fleet.register_tenant(
            "b", tenant_workload(make_tpch_like(scale=0.1, seed=0), "b",
                                 seed=9), opt)
        fleet.register_tenant("c", tenant_workload(other, "c"), opt)
        assert fleet.stats["groups"] == 2
        assert fleet.tenants["a"].group is fleet.tenants["b"].group
        assert fleet.tenants["a"].group is not fleet.tenants["c"].group

    def test_shared_cache_amortizes_sampling(self, schema, opt):
        """Evidence the sharing pays: co-scheduled tenants on one schema
        are served almost entirely from the cross-tenant prefetch (zero
        per-session SampleCF misses), and the group's sampling cost is
        paid once, not per tenant."""
        fleet, wls = make_fleet(schema, 4, opt, fc=FleetConfig(slots=4))
        for tid in wls:
            fleet.submit_recommend(tid, BUDGET)
        fleet.run_until_drained()
        s = fleet.stats
        assert s["groups"] == 1
        assert s["prefetch_targets"] > 0
        for tid in wls:
            ts = fleet.tenant_stats(tid)
            # every sampled estimate came from the shared prefetched cache
            assert ts["samplecf_cache_misses"] == 0
        separate = 0
        for tid, wl in wls.items():
            solo = AdvisorFleetService(FleetConfig(slots=1))
            solo.register_tenant(tid, wl, opt)
            solo.submit_recommend(tid, BUDGET)
            solo.run_until_drained()
            separate += solo.stats["sampling_calls"]
        assert s["sampling_calls"] < separate

    def test_prefetch_off_still_exact(self, schema, opt):
        fleet, wls = make_fleet(schema, 2, opt,
                                fc=FleetConfig(slots=2, prefetch=False))
        tks = {tid: fleet.submit_recommend(tid, BUDGET) for tid in wls}
        fleet.run_until_drained()
        for tid, tk in tks.items():
            fresh = DesignAdvisor(wls[tid], opt).recommend(BUDGET)
            assert identical(tk.result(), fresh)


def test_share_group_keyed_by_backend_and_device(schema):
    """One schema, two backends: two share groups, each estimating where
    its tenants run (the numpy group on the host, the torch group on its
    tenants' device), each tenant exact against a fresh advisor on its
    own options."""
    opts = {b: AdvisorOptions(backend=b, device="cpu") for b in BACKENDS}
    fleet = AdvisorFleetService(FleetConfig(slots=2))
    wls = {}
    for i, b in enumerate(BACKENDS):
        wls[b] = tenant_workload(schema, b, seed=70 + i)
        fleet.register_tenant(b, wls[b], opts[b])
    assert fleet.stats["groups"] == 2
    groups = {b: fleet.tenants[b].group for b in BACKENDS}
    assert groups["numpy"].engine.device is None
    assert groups["torch"].engine.device == torch.device("cpu")
    assert groups["torch"].key[1:] == ("torch", torch.device("cpu"))
    tks = {b: fleet.submit_recommend(b, BUDGET) for b in BACKENDS}
    fleet.run_until_drained()
    for b in BACKENDS:
        fresh = DesignAdvisor(wls[b], opts[b]).recommend(BUDGET)
        assert identical(tks[b].result(), fresh), b
    assert fleet.stats["cost_prefetch_batches"] == 2   # one per device


def test_default_options_raise_without_cuda(schema):
    """The fleet's tenants run on the card unless their options ask for
    the CPU: with default options and no CUDA, registering raises; there
    is no fallback."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default options run there")
    fleet = AdvisorFleetService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet.register_tenant("a", tenant_workload(schema, "a"))
    assert fleet.tenants == {} and fleet.groups == {}


class TestIsolation:
    def test_queue_admission_control(self, schema, opt):
        fleet, wls = make_fleet(schema, 2, opt,
                                fc=FleetConfig(slots=1, max_queue=2))
        fleet.submit_recommend("t0", BUDGET)
        fleet.submit_recommend("t1", BUDGET)
        with pytest.raises(QueueFull):
            fleet.submit_recommend("t0", BUDGET)
        fleet.run_until_drained()
        fleet.submit_recommend("t0", BUDGET)  # capacity freed

    def test_per_tenant_pending_cap(self, schema, opt):
        fleet = AdvisorFleetService(FleetConfig(slots=1))
        fleet.register_tenant("a", tenant_workload(schema, "a"), opt,
                              TenantBudget(max_pending=1))
        fleet.register_tenant("b", tenant_workload(schema, "b", seed=9),
                              opt)
        fleet.submit_recommend("a", BUDGET)
        with pytest.raises(QueueFull):
            fleet.submit_recommend("a", BUDGET)
        fleet.submit_recommend("b", BUDGET)  # other tenants unaffected
        fleet.run_until_drained()

    def test_statement_budget_enforced_before_apply(self, schema, opt):
        fleet = AdvisorFleetService(FleetConfig(slots=1))
        wl = tenant_workload(schema, "a")
        fleet.register_tenant("a", wl, opt,
                              TenantBudget(max_statements=len(
                                  wl.statements) + 1))
        added = tuple(
            dataclasses.replace(s, name=f"a_x{j}") for j, s in enumerate(
                make_scaled_workload(schema, n_statements=3,
                                     seed=7).statements))
        tk = fleet.submit_delta("a", WorkloadDelta(added=added))
        fleet.run_until_drained()
        assert isinstance(tk.exception(), TenantBudgetExceeded)
        # the violating delta never touched the session
        assert len(fleet.tenants["a"].session.workload.statements) == \
            len(wl.statements)
        tk2 = fleet.submit_recommend("a", BUDGET)
        fleet.run_until_drained()
        fresh = DesignAdvisor(wl, opt).recommend(BUDGET)
        assert identical(tk2.result(), fresh)

    def test_failed_delta_isolated_to_tenant(self, schema, opt):
        """An invalid delta resolves ONE ticket with the error; the
        tenant's workload is unchanged and co-batched tenants are
        untouched."""
        fleet, wls = make_fleet(schema, 2, opt, fc=FleetConfig(slots=2))
        bad = fleet.submit_delta(
            "t0", WorkloadDelta(removed=("no_such_statement",)))
        ok = fleet.submit_recommend("t1", BUDGET)
        fleet.run_until_drained()
        assert isinstance(bad.exception(), KeyError)
        fresh = DesignAdvisor(wls["t1"], opt).recommend(BUDGET)
        assert identical(ok.result(), fresh)
        tk = fleet.submit_recommend("t0", BUDGET)
        fleet.run_until_drained()
        fresh0 = DesignAdvisor(wls["t0"], opt).recommend(BUDGET)
        assert identical(tk.result(), fresh0)

    def test_duplicate_tenant_rejected(self, schema, opt):
        fleet = AdvisorFleetService(FleetConfig(slots=1))
        fleet.register_tenant("a", tenant_workload(schema, "a"), opt)
        with pytest.raises(ValueError):
            fleet.register_tenant("a", tenant_workload(schema, "a"), opt)


class TestDurability:
    """Deadlines, retries, quarantine/restore, bounded caches: the
    parity contract through the failure surface."""

    def test_transient_fault_retried_to_success(self, schema, opt):
        """A delta failing with a transient FaultError is requeued with
        step backoff and retried bit-exactly."""
        inj = FaultInjector(specs={"apply_delta": FaultSpec(at=(0,))})
        fleet = AdvisorFleetService(FleetConfig(slots=2), faults=inj)
        wl = tenant_workload(schema, "t0", seed=50)
        fleet.register_tenant("t0", wl, opt)
        delta = WorkloadDelta(removed=(wl.statements[0].name,))
        tk = fleet.submit_delta("t0", delta)
        rk = fleet.submit_recommend("t0", BUDGET)
        fleet.run_until_drained()
        assert tk.result()["applied"] is True
        assert tk.attempts == 2                  # one fault, one success
        assert fleet.stats["retries"] == 1
        assert fleet.stats["failures"] == 0
        fresh = DesignAdvisor(wl.apply_delta(delta), opt).recommend(BUDGET)
        assert identical(rk.result(), fresh)

    def test_retry_exhaustion_quarantines_then_restore(self, schema, opt):
        """A persistent fault exhausts the bounded retries, trips the
        circuit breaker, flushes the tenant's queue with
        TenantQuarantined and rejects submits; checkpoint readmission
        brings the tenant back `==` a fresh advisor."""
        inj = FaultInjector(specs={"apply_delta": 1.0})  # always fires
        fc = FleetConfig(slots=1, retry_backoff=(1, 2),
                         quarantine_after=1)
        fleet = AdvisorFleetService(fc, faults=inj)
        wl = tenant_workload(schema, "t0", seed=50)
        fleet.register_tenant("t0", wl, opt)
        tk = fleet.submit_delta(
            "t0", WorkloadDelta(removed=(wl.statements[0].name,)))
        queued = fleet.submit_recommend("t0", BUDGET)
        fleet.run_until_drained()
        assert isinstance(tk.exception(), FaultError)
        assert tk.attempts == 3                 # 1 + len(retry_backoff)
        assert isinstance(queued.exception(), TenantQuarantined)
        s = fleet.stats
        assert s["quarantines"] == 1 and s["quarantined_tenants"] == 1
        with pytest.raises(TenantQuarantined):
            fleet.submit_recommend("t0", BUDGET)
        fleet.readmit_tenant("t0")
        assert fleet.stats["restores"] == 1
        rk = fleet.submit_recommend("t0", BUDGET)
        fleet.run_until_drained()
        # the faulted delta never applied: parity vs the ORIGINAL workload
        fresh = DesignAdvisor(wl, opt).recommend(BUDGET)
        assert identical(rk.result(), fresh)

    def test_crash_then_auto_readmit_parity(self, schema, opt):
        """crash_tenant drops the session; the quarantine_steps cooldown
        restores it from the post-delta checkpoint, so the recovered
        tenant recommends against its CURRENT workload."""
        fc = FleetConfig(slots=2, quarantine_steps=2)
        fleet = AdvisorFleetService(fc)
        wl = tenant_workload(schema, "t0", seed=50)
        fleet.register_tenant("t0", wl, opt)
        delta = WorkloadDelta(removed=(wl.statements[0].name,
                                       wl.statements[1].name))
        fleet.submit_delta("t0", delta)
        fleet.run_until_drained()
        wl = wl.apply_delta(delta)
        fleet.crash_tenant("t0")
        assert fleet.tenants["t0"].session is None
        for _ in range(10):                     # idle ticks drive cooldown
            if fleet.tenants["t0"].quarantined_at is None:
                break
            fleet.step()
        assert fleet.tenants["t0"].quarantined_at is None
        ts = fleet.tenant_stats("t0")
        assert ts["restores"] == 1 and ts["n_statements"] == \
            len(wl.statements)
        rk = fleet.submit_recommend("t0", BUDGET)
        fleet.run_until_drained()
        assert identical(rk.result(),
                         DesignAdvisor(wl, opt).recommend(BUDGET))
        assert len(fleet.restore_seconds) == 1

    def test_deadline_expires_queued_request(self, schema, opt):
        fleet, wls = make_fleet(schema, 1, opt, fc=FleetConfig(slots=1))
        first = fleet.submit_recommend("t0", BUDGET)
        late = fleet.submit_recommend("t0", BUDGET, deadline_steps=1)
        fleet.run_until_drained()
        assert identical(first.result(),
                         DesignAdvisor(wls["t0"], opt).recommend(BUDGET))
        with pytest.raises(TicketTimeout, match="t0.*deadline"):
            late.result()
        assert fleet.stats["timeouts"] == 1

    def test_deadline_pressure_degrades_recommend(self, schema, opt):
        """With degraded_budget set, an expiring recommend is served NOW
        at the smaller workload-compression budget (exact for that
        budget, certificate attached) instead of failing."""
        fc = FleetConfig(slots=1, degraded_budget=6)
        fleet = AdvisorFleetService(fc)
        wl0 = tenant_workload(schema, "t0", seed=50)
        wl1 = tenant_workload(schema, "t1", seed=51)
        fleet.register_tenant("t0", wl0, opt)
        fleet.register_tenant("t1", wl1, opt)
        fleet.submit_recommend("t0", BUDGET)      # occupies the one slot
        tk = fleet.submit_recommend("t1", BUDGET, deadline_steps=1)
        fleet.run_until_drained()
        assert tk.degraded is True
        assert fleet.stats["degraded_recommends"] == 1
        dopt = dataclasses.replace(opt, compression_budget=6)
        fresh = DesignAdvisor(wl1, dopt).recommend(BUDGET)
        rec = tk.result()
        assert identical(rec, fresh)
        assert 0 < rec.n_representatives <= 6
        assert rec.compression_error_bound >= 0.0

    def test_drain_stall_raises_with_pending_counts(self, schema, opt):
        fleet, wls = make_fleet(schema, 1, opt, fc=FleetConfig(slots=1))
        tk = fleet.submit_recommend("t0", BUDGET)
        with pytest.raises(DrainStalled) as ei:
            fleet.run_until_drained(max_steps=0)
        assert ei.value.queued == 1
        assert ei.value.pending_by_tenant == {"t0": 1}
        fleet.run_until_drained()                 # work was NOT lost
        assert identical(tk.result(),
                         DesignAdvisor(wls["t0"], opt).recommend(BUDGET))

    def test_prefetch_failure_counted_not_fatal(self, schema, opt):
        """A failing prefetch batch is counted, attached to the affected
        tickets, and the recommends still resolve bit-exactly (the warm-
        up is pure optimization)."""
        inj = FaultInjector(specs={"prefetch": 1.0})
        fleet = AdvisorFleetService(FleetConfig(slots=2), faults=inj)
        wls = {}
        for i in range(2):
            tid = f"t{i}"
            wls[tid] = tenant_workload(schema, tid, seed=50 + i)
            fleet.register_tenant(tid, wls[tid], opt)
        tks = {tid: fleet.submit_recommend(tid, BUDGET) for tid in wls}
        fleet.run_until_drained()
        s = fleet.stats
        assert s["prefetch_failures"] >= 1
        assert s["prefetch_batches"] == 0         # every batch faulted
        assert any(isinstance(tk.prefetch_error, FaultError)
                   for tk in tks.values())
        for tid, tk in tks.items():
            assert identical(tk.result(),
                             DesignAdvisor(wls[tid], opt).recommend(BUDGET))

    def test_result_default_timeout_names_tenant_and_kind(self, schema,
                                                          opt):
        """A ticket awaited while the loop is not running fails fast
        with a message saying WHOSE request is stuck, not a silent
        forever-block."""
        fleet, _ = make_fleet(schema, 1, opt)
        tk = fleet.submit_recommend("t0", BUDGET)
        with pytest.raises(TicketTimeout, match="'t0' recommend"):
            tk.result(timeout=0.01)
        fleet.run_until_drained()
        tk.result()                               # resolves normally now

    def test_bounded_group_cache_keeps_parity(self, schema, opt):
        """A tight share-group LRU forces evictions across drift rounds;
        every recommendation stays `==` the fresh advisor."""
        fleet, wls = make_fleet(schema, 2, opt,
                                fc=FleetConfig(slots=2, cache_entries=8))
        for rnd in range(2):
            tks = {}
            for i, tid in enumerate(list(wls)):
                added = tuple(dataclasses.replace(s, name=f"{tid}_b{rnd}{j}")
                              for j, s in enumerate(make_scaled_workload(
                                  schema, n_statements=2,
                                  seed=700 + rnd * 10 + i).statements))
                delta = WorkloadDelta(added=added)
                fleet.submit_delta(tid, delta)
                wls[tid] = wls[tid].apply_delta(delta)
                tks[tid] = fleet.submit_recommend(tid, BUDGET)
            fleet.run_until_drained()
            for tid, tk in tks.items():
                fresh = DesignAdvisor(wls[tid], opt).recommend(BUDGET)
                assert identical(tk.result(), fresh), (rnd, tid)
        s = fleet.stats
        assert s["shared_cache_entries"] <= 8
        assert s["shared_cache_evictions"] > 0


class TestDurableStoreWiring:
    """The fleet x DurableStore integration surface (the store's own
    semantics and the crash-point harness live in
    test_torch_durability.py): journal-before-apply ordering, budget
    metadata round-tripping, and store-backed fleets behaving
    identically to store-less ones."""

    def test_store_backed_fleet_same_answers_as_storeless(self, schema,
                                                          opt, tmp_path):
        plain, wls = make_fleet(schema, 2, opt)
        store = DurableStore(tmp_path, compact_after=2)
        durable = AdvisorFleetService(FleetConfig(slots=3), store=store)
        for tid, wl in wls.items():
            durable.register_tenant(tid, wl, opt)
        added = tuple(dataclasses.replace(s, name=f"d{j}")
                      for j, s in enumerate(make_scaled_workload(
                          schema, n_statements=2, seed=900).statements))
        results = {}
        for fleet in (plain, durable):
            fleet.submit_delta("t0", WorkloadDelta(added=added))
            tk = fleet.submit_recommend("t0", BUDGET)
            fleet.run_until_drained()
            results[fleet] = tk.result()
        assert identical(results[plain], results[durable])
        assert durable.stats["wal_appends"] == 1

    def test_budget_metadata_survives_recovery(self, schema, opt,
                                               tmp_path):
        store = DurableStore(tmp_path)
        fleet = AdvisorFleetService(FleetConfig(slots=1), store=store)
        wl = tenant_workload(schema, "t0", seed=50)
        budget = TenantBudget(max_statements=len(wl.statements) + 1,
                              max_pending=7)
        fleet.register_tenant("t0", wl, opt, budget=budget)
        store.close()
        f2 = AdvisorFleetService.recover(tmp_path)
        got = f2.tenants["t0"].budget
        assert got.max_statements == budget.max_statements
        assert got.max_pending == budget.max_pending
        # and the cap is live: the oversize delta is rejected before it
        # is ever journaled, so the next recovery replays nothing
        added = tuple(dataclasses.replace(s, name=f"x{j}")
                      for j, s in enumerate(make_scaled_workload(
                          schema, n_statements=3, seed=901).statements))
        tk = f2.submit_delta("t0", WorkloadDelta(added=added))
        f2.run_until_drained()
        assert isinstance(tk.exception(30), TenantBudgetExceeded)
        f2.store.close()
        f3 = AdvisorFleetService.recover(tmp_path)
        assert len(f3.tenants["t0"].session.workload.statements) \
            == len(wl.statements)


# ---------------------------------------------------------------------------
# The stacked cost phase (tests/test_backend_unified.py's twins)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unified_schema():
    return make_tpch_like(scale=0.2, z=0, seed=0)


@pytest.fixture(scope="module")
def unified_workload(unified_schema):
    return make_tpch_workload(unified_schema, insert_weight=0.1)


class TestStackedCostBatch:
    """The fleet cost phase's stacked scorer vs per-job scoring."""

    @staticmethod
    def _jobs(workload, schema, device):
        adv = DesignAdvisor(workload, AdvisorOptions(backend="numpy"))
        base = base_configuration(schema)
        eng = CostEngine(workload, adv.sizes, device=device)
        jobs, per_job = [], []
        for q in workload.queries()[:4]:
            raw = cand.syntactically_relevant(q, schema.tables[q.table])
            raw = cand.expand_with_compression(raw, ("NS", "LDICT"))
            adv.estimate_sizes(raw)
            jobs.append(eng.cost_job_arrays(q, base, raw))
            per_job.append(eng.candidate_query_costs(q, base, raw))
        assert len({len(j["cov"]) for j in jobs}) > 1   # rows are padded
        return jobs, per_job

    @pytest.mark.parametrize("device", [None, torch.device("cpu")],
                             ids=["numpy", "torch"])
    def test_stack_bitwise_equals_per_job(self, unified_workload,
                                          unified_schema, device):
        jobs, per_job = self._jobs(unified_workload, unified_schema, device)
        costs = batched_candidate_costs(jobs, device=device)
        assert costs.dtype == np.float64
        for i, want in enumerate(per_job):
            np.testing.assert_array_equal(costs[i, :len(want)], want)

    def test_requires_secondary_free_base(self, unified_workload,
                                          unified_schema):
        adv = DesignAdvisor(unified_workload,
                            AdvisorOptions(backend="numpy"))
        base = base_configuration(unified_schema)
        q = unified_workload.queries()[0]
        raw = cand.syntactically_relevant(q, unified_schema.tables[q.table])
        eng = CostEngine(unified_workload, adv.sizes)
        sec = next(i for i in raw if not i.clustered)
        with pytest.raises(ValueError, match="secondary-free"):
            eng.cost_job_arrays(q, base.add(sec), raw)


def test_fleet_parity_with_cost_prefetch(unified_schema, opt):
    """Every tenant exact against a fresh advisor while its candidate
    costs come from the fleet's stacked cost phase, and every prefetched
    job is consumed by its recommend."""
    fleet = AdvisorFleetService(FleetConfig(slots=3))
    wls = {}
    for i in range(3):
        tid = f"t{i}"
        wls[tid] = tenant_workload(unified_schema, tid, n=12, seed=60 + i)
        fleet.register_tenant(tid, wls[tid], opt)
    for rnd in range(2):
        tks = {}
        for i, tid in enumerate(list(wls)):
            extra = make_scaled_workload(
                unified_schema, n_statements=2, seed=500 + rnd * 10 + i)
            added = [dataclasses.replace(s, name=f"{tid}_r{rnd}_{s.name}")
                     for s in extra.statements]
            d = WorkloadDelta(added=tuple(added))
            wls[tid] = wls[tid].apply_delta(d)
            fleet.submit_delta(tid, d)
            tks[tid] = fleet.submit_recommend(tid, BUDGET)
        fleet.run_until_drained()
        for tid, tk in tks.items():
            fresh = DesignAdvisor(wls[tid], opt).recommend(BUDGET)
            assert identical(tk.result(), fresh), (opt.backend, rnd, tid)
    st = fleet.stats
    assert st["cost_prefetch_batches"] > 0
    assert st["cost_prefetch_jobs"] > 0
    consumed = sum(t.session.cost_prefetch_consumed
                   for t in fleet.tenants.values())
    assert consumed == st["cost_prefetch_jobs"]
