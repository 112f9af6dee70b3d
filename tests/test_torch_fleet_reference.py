"""The port's fleet and durable store against the JAX package's, on the
same inputs.

* numpy backend: under the same `FaultInjector` seed, the port's fleet
  gives every ticket the reference's outcome (error type, attempts,
  degraded), every recommendation `==` the reference's, and every
  `stats` counter, tenant counter and `faults.stats()` equal, through
  retries, deadlines, degraded recommends, crashes, readmissions and
  quarantines; with a durable store also through torn appends, failed
  group commits, a flipped bit and a recovery.
* torch backend on the CPU against the reference's jax fleet (Pallas
  interpret mode): the same plans each round, the same configurations
  and greedy steps up to the float32 ping-pong (ROADMAP Queue C: where
  the two float32 greedies enter it on different tied steps, their
  configurations differ at one cost), cost within rtol 1e-6, the same
  prefetch and cost-phase counters; each round `==` a fresh torch/cpu
  `DesignAdvisor`.  Fault schedules are
  not compared here: the torch planner replays per plan, the
  reference's per record, so one seed fires on different work.
* The durable frame: `frame_record` gives the reference's bytes, both
  stores find the same record boundaries, and a WAL the reference wrote
  reads back through the port's scan into the port's deltas (payloads
  pickle each package's own classes, so they load through an unpickler
  that maps the reference's module names to the port's).
* The record type byte: the reference recovers a tenant without a
  delta whose type byte took a flipped bit, and without an error; the
  port quarantines it, or truncates a torn tail.
"""
import dataclasses
import io
import math
import pickle

import numpy as np
import pytest

import repro.core as rc
from repro.core import durability as ref_durability
from repro.serve import advisor_service as ref_service
import repro_torch.core as pt
from repro_torch.core import durability as port_durability
from repro_torch.serve import advisor_service as port_service
from torch_port_util import (assert_same_steps_up_to_ping_pong, labels,
                             port_schema, port_workload, statement_spec)

BUDGET = 2_000_000


@pytest.fixture(scope="module")
def ref_schema():
    return rc.make_tpch_like(scale=0.1, z=0, seed=0)


@pytest.fixture(scope="module")
def schema(ref_schema):
    return port_schema(ref_schema)


def ref_tenant_workload(ref_schema, tid, n, seed):
    wl = rc.make_scaled_workload(ref_schema, n_statements=n, seed=seed)
    return dataclasses.replace(
        wl, statements=[dataclasses.replace(s, name=f"{tid}_{s.name}")
                        for s in wl.statements])


def port_statements(ref_stmts, schema):
    return port_workload(rc.Workload(schema=None, statements=list(ref_stmts)),
                         schema).statements


def port_delta(d, schema):
    return pt.WorkloadDelta(added=tuple(port_statements(d.added, schema)),
                            removed=d.removed, reweighted=d.reweighted)


def rec_summary(rec):
    return (labels(rec.config), rec.cost, rec.used_bytes, rec.base_cost,
            rec.n_sampled, rec.n_deduced, rec.estimation_cost_pages,
            rec.pool_size, rec.candidate_count, tuple(rec.steps),
            rec.compression_error_bound, rec.n_representatives)


def outcome(tk):
    """A ticket's outcome as plain data: kind, attempts, degraded, error
    type, and the recommendation or the delta summary."""
    err = tk.exception(30)
    if err is not None:
        got = type(err).__name__
    elif tk.kind == "recommend":
        got = rec_summary(tk.result())
    else:
        got = tk.result()
    return (tk.tenant_id, tk.kind, tk.attempts, tk.degraded, got)


# ---------------------------------------------------------------------------
# numpy: the port's fleet == the reference's under one fault seed
# ---------------------------------------------------------------------------

STORM_RATES = {"apply_delta": 0.15, "estimation": 0.1, "costing": 0.1,
               "prefetch": 0.25, "planner_replay": 0.1}


def storm_script(ref_schema, n_tenants, rounds, seed):
    """The reference's tenants and per-round deltas (the storm of the
    reference's benchmarks/fault_recovery.py at test size): removals,
    additions and reweights from a seeded generator, plus a crash victim
    per round."""
    rng = np.random.default_rng(seed)
    wls = {f"t{i}": ref_tenant_workload(ref_schema, f"t{i}", 10, 31 + i)
           for i in range(n_tenants)}
    mirror = dict(wls)
    script = []
    for rnd in range(rounds):
        victim = f"t{int(rng.integers(n_tenants))}"
        deltas = {}
        for i, tid in enumerate(wls):
            names = [s.name for s in mirror[tid].statements]
            removed = tuple(rng.choice(names, size=2, replace=False))
            added = tuple(
                dataclasses.replace(s, name=f"{tid}_r{rnd}_{j}")
                for j, s in enumerate(rc.make_scaled_workload(
                    ref_schema, n_statements=2,
                    seed=1000 + 10 * rnd + i).statements))
            keep = [n for n in names if n not in removed]
            rw = tuple((str(n), float(rng.uniform(0.5, 1.5)))
                       for n in rng.choice(keep, size=2, replace=False))
            deltas[tid] = rc.WorkloadDelta(added=added, removed=removed,
                                           reweighted=rw)
            # the script follows the workloads the deltas intend; where a
            # delta fails in the fleet, a later one may name a statement
            # the tenant lacks and fail too, in both packages alike
            mirror[tid] = mirror[tid].apply_delta(deltas[tid])
        script.append((victim, deltas))
    return wls, script


def run_storm(pkg, service, wls, script, schema, seed, store=None,
              disk=None):
    """Drive one package's numpy fleet through the scripted storm;
    returns (fleet, injector, outcomes per round)."""
    specs = dict(STORM_RATES, **(disk or {}))
    faults = pkg.FaultInjector(seed=seed, specs=specs)
    fc = service.FleetConfig(slots=3, retry_backoff=(1, 2, 4),
                             quarantine_after=3, degraded_budget=6)
    fleet = service.AdvisorFleetService(fc, faults=faults, store=store)
    opt = pkg.AdvisorOptions(backend="numpy")
    conv = (lambda wl: wl) if pkg is rc else \
        (lambda wl: port_workload(wl, schema))
    conv_d = (lambda d: d) if pkg is rc else (lambda d: port_delta(d, schema))
    for tid, wl in wls.items():
        fleet.register_tenant(tid, conv(wl), opt)
    rounds = []
    for victim, deltas in script:
        if fleet.tenants[victim].quarantined_at is None:
            fleet.crash_tenant(victim)
        for tid, t in fleet.tenants.items():
            if t.quarantined_at is not None and t.snapshot is not None:
                fleet.readmit_tenant(tid)
        tks = []
        for i, tid in enumerate(wls):
            tks.append(fleet.submit_delta(tid, conv_d(deltas[tid])))
            tks.append(fleet.submit_recommend(
                tid, BUDGET, deadline_steps=4 if i % 2 else None))
        fleet.run_until_drained()
        rounds.append([outcome(tk) for tk in tks])
    return fleet, faults, rounds


def assert_same_fleet(got, want):
    assert got.stats == want.stats
    for tid in want.tenants:
        assert got.tenant_stats(tid) == want.tenant_stats(tid), tid
        gs, ws = got.tenants[tid].session, want.tenants[tid].session
        assert (gs is None) == (ws is None)
        if ws is not None:
            assert [statement_spec(s) for s in gs.workload.statements] == \
                [statement_spec(s) for s in ws.workload.statements]


@pytest.mark.parametrize("seed", [14, 23])
def test_numpy_fleet_equals_reference_under_fault_seed(ref_schema, schema,
                                                       seed):
    wls, script = storm_script(ref_schema, 4, 3, seed)
    ref, ref_faults, ref_rounds = run_storm(rc, ref_service, wls, script,
                                            schema, seed)
    got, got_faults, got_rounds = run_storm(pt, port_service, wls, script,
                                            schema, seed)
    assert got_rounds == ref_rounds
    assert got_faults.stats() == ref_faults.stats()
    assert_same_fleet(got, ref)
    # the storm stormed: faults fired and the fleet retried, crashed,
    # restored
    fired = ref_faults.stats()["fired"]
    assert sum(fired.values()) > 0 and ref.stats["retries"] > 0
    assert ref.stats["restores"] > 0


DISK = {"disk_write": 0.1, "fsync": 0.1}


def test_numpy_durable_fleet_equals_reference(ref_schema, schema, tmp_path):
    """With a durable store and disk faults: the same outcomes, counters
    and store counters as the reference, and after process death the
    same recovery (workloads, errors, quarantines) and recommendations."""
    wls, script = storm_script(ref_schema, 3, 3, 7)
    fleets = {}
    for name, pkg, service, durability in (
            ("ref", rc, ref_service, ref_durability),
            ("port", pt, port_service, port_durability)):
        disk = dict(DISK, bit_flip=pkg.FaultSpec(at=(5,)))
        store = durability.DurableStore(tmp_path / name, compact_after=4)
        fleets[name] = run_storm(pkg, service, wls, script, schema, 7,
                                 store=store, disk=disk)
        store.close()
    (ref, ref_faults, ref_rounds), (got, got_faults, got_rounds) = \
        fleets["ref"], fleets["port"]
    assert got_rounds == ref_rounds
    assert got_faults.stats() == ref_faults.stats()
    assert got.store.stats() == ref.store.stats()
    assert_same_fleet(got, ref)
    fired = ref_faults.stats()["fired"]
    assert fired["disk_write"] > 0 and fired["fsync"] > 0
    assert fired["bit_flip"] == 1

    ref2 = ref_service.AdvisorFleetService.recover(tmp_path / "ref")
    got2 = port_service.AdvisorFleetService.recover(tmp_path / "port")
    assert sorted(got2.recovery_errors) == sorted(ref2.recovery_errors)
    assert {type(e).__name__ for e in got2.recovery_errors.values()} == \
        {type(e).__name__ for e in ref2.recovery_errors.values()}
    assert got2.recovery_errors          # the flipped bit quarantines
    assert_same_fleet(got2, ref2)
    for tid, t in ref2.tenants.items():
        if t.quarantined_at is not None:
            continue
        tk_r = ref2.submit_recommend(tid, BUDGET)
        tk_p = got2.submit_recommend(tid, BUDGET)
        ref2.run_until_drained()
        got2.run_until_drained()
        assert outcome(tk_p) == outcome(tk_r)
        fresh = pt.DesignAdvisor(got2.tenants[tid].session.workload,
                                 pt.AdvisorOptions(backend="numpy")
                                 ).recommend(BUDGET)
        assert rec_summary(tk_p.result())[:3] == \
            (labels(fresh.config), fresh.cost, fresh.used_bytes)


# ---------------------------------------------------------------------------
# torch on the CPU against the reference's jax fleet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unified_ref_schema():
    return rc.make_tpch_like(scale=0.2, z=0, seed=0)


@pytest.fixture(scope="module")
def jax_fleet_rounds(unified_ref_schema):
    """The reference's jax fleet (tests/test_backend_unified.py's cost
    prefetch shape): 3 tenants of 12 statements, 2 rounds of 2 added
    statements and a recommend each; per round the deltas and the
    recommendations, then the fleet's counters."""
    opt = rc.AdvisorOptions(backend="jax")
    fleet = ref_service.AdvisorFleetService(
        ref_service.FleetConfig(slots=3, backend="jax"))
    wls = {}
    for i in range(3):
        tid = f"t{i}"
        wls[tid] = ref_tenant_workload(unified_ref_schema, tid, 12, 60 + i)
        fleet.register_tenant(tid, wls[tid], opt)
    rounds = []
    for rnd in range(2):
        deltas, tks = {}, {}
        for i, tid in enumerate(wls):
            extra = rc.make_scaled_workload(
                unified_ref_schema, n_statements=2, seed=500 + rnd * 10 + i)
            deltas[tid] = rc.WorkloadDelta(added=tuple(
                dataclasses.replace(s, name=f"{tid}_r{rnd}_{s.name}")
                for s in extra.statements))
            fleet.submit_delta(tid, deltas[tid])
            tks[tid] = fleet.submit_recommend(tid, BUDGET)
        fleet.run_until_drained()
        rounds.append((deltas, {tid: tk.result() for tid, tk in
                                tks.items()}))
    return wls, rounds, fleet.stats


def _cost_unchanged(step: str) -> bool:
    before, after = step.rsplit("cost ", 1)[1].split("->")
    return before == after


def ping_pong_divergence(got_steps, want_steps) -> bool:
    """True when the two greedy runs part at a step that leaves the cost
    unchanged and every later step of both runs leaves it unchanged too:
    the float32 ping-pong between tied layouts (ROADMAP Queue C), entered
    on a different tied step by each float32 backend.  The two
    configurations may then differ at one cost.  False when the runs do
    not part, or part only where one stops."""
    k = next((i for i, (a, b) in enumerate(zip(got_steps, want_steps))
              if a != b), None)
    if k is None:
        return False
    assert all(_cost_unchanged(s) for s in got_steps[k:] + want_steps[k:])
    return True


SHARED_COUNTERS = ("groups", "steps", "retired", "prefetch_batches",
                   "prefetch_targets", "prefetch_hits",
                   "cost_prefetch_batches", "cost_prefetch_jobs",
                   "shared_cache_entries", "sampling_calls")


def test_torch_cpu_fleet_equals_reference_jax_fleet(unified_ref_schema,
                                                    jax_fleet_rounds):
    wls, rounds, ref_stats = jax_fleet_rounds
    schema = port_schema(unified_ref_schema)
    opt = pt.AdvisorOptions(backend="torch", device="cpu")
    fleet = port_service.AdvisorFleetService(
        port_service.FleetConfig(slots=3))
    mirror = {tid: port_workload(wl, schema) for tid, wl in wls.items()}
    for tid, wl in mirror.items():
        fleet.register_tenant(tid, wl, opt)
    for deltas, want in rounds:
        tks = {}
        for tid, d in deltas.items():
            pd = port_delta(d, schema)
            fleet.submit_delta(tid, pd)
            mirror[tid] = mirror[tid].apply_delta(pd)
            tks[tid] = fleet.submit_recommend(tid, BUDGET)
        fleet.run_until_drained()
        for tid, tk in tks.items():
            got, w = tk.result(), want[tid]
            fresh = pt.DesignAdvisor(mirror[tid], opt).recommend(BUDGET)
            assert (got.config, got.cost, got.used_bytes, got.steps) == \
                (fresh.config, fresh.cost, fresh.used_bytes, fresh.steps)
            if not ping_pong_divergence(got.steps, w.steps):
                assert labels(got.config) == labels(w.config), tid
                assert_same_steps_up_to_ping_pong(got.steps, w.steps)
            assert (got.estimation_plan.f, got.n_sampled, got.n_deduced) \
                == (w.estimation_plan.f, w.n_sampled, w.n_deduced)
            assert math.isclose(got.cost, w.cost, rel_tol=1e-6)
            assert (got.pool_size, got.candidate_count) == \
                (w.pool_size, w.candidate_count)
    got_stats = fleet.stats
    assert {k: got_stats[k] for k in SHARED_COUNTERS} == \
        {k: ref_stats[k] for k in SHARED_COUNTERS}
    consumed = sum(t.session.cost_prefetch_consumed
                   for t in fleet.tenants.values())
    assert consumed == got_stats["cost_prefetch_jobs"] > 0


# ---------------------------------------------------------------------------
# The durable frame
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rtype, payload", [
    (1, b""), (1, b"hello"), (2, pickle.dumps(3)), (3, b"\x00" * 200),
    (2, bytes(range(256)) * 9)])
def test_frame_record_equals_reference(rtype, payload):
    for name in ("WAL_MAGIC", "WAL_FORMAT_VERSION", "REC_DELTA",
                 "REC_ABORT", "REC_MANIFEST"):
        assert getattr(port_durability, name) == \
            getattr(ref_durability, name)
    assert port_durability._HEADER.format == ref_durability._HEADER.format
    assert port_durability.frame_record(rtype, payload) == \
        ref_durability.frame_record(rtype, payload)


def test_record_boundaries_equal_reference(tmp_path):
    """The same WAL bytes, a torn tail included, give both stores the
    same boundaries and both scans the same records."""
    frames = [ref_durability.frame_record(1, pickle.dumps((k, b"d" * k)))
              for k in range(1, 6)]
    frames.insert(3, ref_durability.frame_record(2, pickle.dumps(2)))
    blob = b"".join(frames) + frames[0][:9]
    bounds = []
    for durability in (ref_durability, port_durability):
        store = durability.DurableStore(tmp_path / durability.__name__)
        (store.root / "wal" / "t.wal").write_bytes(blob)
        bounds.append(store.wal_record_boundaries("t"))
    assert bounds[0] == bounds[1]
    assert len(bounds[0]) == len(frames) + 1
    want = ref_durability.scan_records(blob)
    got = port_durability.scan_records(blob, port_durability.WAL_TYPES)
    assert (got.records, got.good_end, got.torn_tail, got.corrupt_at) == \
        (want.records, want.good_end, want.torn_tail, want.corrupt_at)


class _PortUnpickler(pickle.Unpickler):
    """Loads a reference-written payload as the port's classes."""

    def find_class(self, module, name):
        if module == "repro" or module.startswith("repro."):
            module = "repro_torch" + module[len("repro"):]
        return super().find_class(module, name)


def test_reference_wal_reads_back_as_port_deltas(ref_schema, schema,
                                                 tmp_path):
    pool = [dataclasses.replace(s, name=f"p{i}") for i, s in enumerate(
        rc.make_scaled_workload(ref_schema, n_statements=6,
                                seed=6).statements)]
    ref_deltas = [rc.WorkloadDelta(added=tuple(pool[0:2])),
                  rc.WorkloadDelta(added=(pool[2],), removed=("p0",),
                                   reweighted=(("p1", 2.5),)),
                  rc.WorkloadDelta(added=tuple(pool[3:6]))]
    store = ref_durability.DurableStore(tmp_path)
    store.register("t0", b"snap")
    for d in ref_deltas:
        store.log_delta("t0", d)
    store.log_abort("t0", 2)
    store.close()
    data = (tmp_path / "wal" / "t0.wal").read_bytes()
    scan = port_durability.scan_records(data, port_durability.WAL_TYPES)
    assert not scan.torn_tail and scan.corrupt_at is None
    assert [t for t, _ in scan.records] == [1, 1, 1, 2]
    loaded = [_PortUnpickler(io.BytesIO(p)).load() for _, p in scan.records]
    assert [seq for seq, _ in loaded[:3]] == [1, 2, 3] and loaded[3] == 2
    want = [port_delta(d, schema) for d in ref_deltas]
    assert [d for _, d in loaded[:3]] == want
    assert all(type(d) is pt.WorkloadDelta for _, d in loaded[:3])
    assert port_durability.DurableStore(tmp_path).wal_record_boundaries(
        "t0") == ref_durability.DurableStore(tmp_path).wal_record_boundaries(
        "t0")


@pytest.mark.parametrize("victim_record", [0, 2])
def test_type_byte_flip_reference_skips_port_detects(ref_schema, schema,
                                                     tmp_path,
                                                     victim_record):
    """Side by side on the same damage: bit 0 of the type byte of one
    DELTA record (type 1 -> 0).  The reference's scan accepts the record
    and its replay skips it: the tenant recovers without that delta and
    without an error.  The port's scan rejects it: mid-log, the tenant
    is quarantined; as the last record, a torn tail is truncated and
    the tenant recovers the prefix before it."""
    pool = [dataclasses.replace(s, name=f"p{i}") for i, s in enumerate(
        rc.make_scaled_workload(ref_schema, n_statements=3,
                                seed=6).statements)]
    wl = ref_tenant_workload(ref_schema, "t0", 10, 1)
    ref_deltas = [rc.WorkloadDelta(added=(pool[i],)) for i in range(3)]
    runs = {}
    for name, pkg, service, durability in (
            ("ref", rc, ref_service, ref_durability),
            ("port", pt, port_service, port_durability)):
        root = tmp_path / name
        store = durability.DurableStore(root)
        fleet = service.AdvisorFleetService(service.FleetConfig(slots=1),
                                            store=store)
        opt = pkg.AdvisorOptions(backend="numpy")
        twl = wl if pkg is rc else port_workload(wl, schema)
        fleet.register_tenant("t0", twl, opt)
        for d in ref_deltas:
            tk = fleet.submit_delta("t0", d if pkg is rc
                                    else port_delta(d, schema))
            fleet.run_until_drained()
            assert tk.exception(30) is None
        store.close()
        bounds = durability.DurableStore(root).wal_record_boundaries("t0")
        wal = root / "wal" / "t0.wal"
        data = bytearray(wal.read_bytes())
        data[bounds[victim_record] + 6] ^= 1
        wal.write_bytes(bytes(data))
        runs[name] = service.AdvisorFleetService.recover(root)
    ref, got = runs["ref"], runs["port"]
    kept = [d for k, d in enumerate(ref_deltas) if k != victim_record]
    want_names = [s.name for s in wl.statements] + \
        [s.name for d in kept for s in d.added]
    # the reference: healthy, no error, the damaged delta silently gone
    assert ref.recovery_errors == {}
    assert ref.tenants["t0"].quarantined_at is None
    assert [s.name for s in ref.tenants["t0"].session.workload.statements] \
        == want_names
    t0 = got.tenants["t0"]
    if victim_record < len(ref_deltas) - 1:
        assert isinstance(got.recovery_errors["t0"], pt.LogCorrupt)
        assert t0.quarantined_at is not None
    else:
        # the last record: a torn tail, and the recovered state is the
        # journaled prefix (here the same statements as the reference's)
        assert got.recovery_errors == {}
        assert got.store.torn_tail_truncations == 1
        assert [s.name for s in t0.session.workload.statements] == \
            want_names
