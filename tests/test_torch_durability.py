"""The port's durable crash recovery: WAL framing, atomic snapshots, and
the exact-parity contract surviving real process death (the twin of
tests/test_durability.py).

Four claims under test:

1. The record framing (`frame_record`/`scan_records`) is adversarially
   robust: any byte-level damage is classified as either a torn tail
   (invalid bytes at the physical end, truncated, never an error) or
   mid-log corruption (invalid bytes with valid records after them,
   reported, poisoning only that log), and a single flipped bit can
   never slip past the scan, the record type byte included: a scan
   takes the record types its file may hold.
2. `DurableStore` write-ahead semantics: deltas are journaled before
   they are applied, failed applies are compensated with ABORT records,
   compaction atomically rotates a manifest and empties the WAL, and
   `recover()` reconstructs exactly the journaled-and-not-aborted
   suffix past the manifest.
3. The crash-point harness: for a fleet storm, killing the process
   (copy the store directory, truncate the victim WAL) at EVERY record
   boundary, at mid-record byte offsets and at arbitrary damaged bytes,
   then `AdvisorFleetService.recover()` yields tenants whose next
   recommendation is exactly `==` a fresh `DesignAdvisor` on the
   recovered workload; torn tails are truncated, corrupt tenants
   quarantined, and recovery itself never raises.
4. The disk fault sites (`disk_write`/`fsync`/`bit_flip`) inject
   exactly their documented semantics and the fleet's retry path keeps
   both the live session and the durable log replay-consistent.

Every fleet-level test runs on the numpy backend and on the torch
backend on the CPU (`opt` fixture); snapshots carry `device="cpu"`.
"""
import dataclasses
import pickle
import shutil

import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core import (AdvisorOptions, DesignAdvisor, DurableStore,
                              FaultInjector, FaultSpec, LogCorrupt, Workload,
                              WorkloadDelta, make_scaled_workload,
                              make_tpch_like)
from repro_torch.core.durability import (REC_ABORT, REC_DELTA, REC_MANIFEST,
                                         SNAP_TYPES, WAL_MAGIC, WAL_TYPES,
                                         _HEADER, frame_record, scan_records)
from repro_torch.serve.advisor_service import (AdvisorFleetService,
                                               FleetConfig, TenantQuarantined)

BACKENDS = ["numpy", "torch"]
BUDGET = 2e6
ALL_TYPES = WAL_TYPES + SNAP_TYPES


@pytest.fixture(scope="module")
def schema():
    return make_tpch_like(scale=0.1, z=0, seed=0)


@pytest.fixture(scope="module")
def workload(schema):
    return make_scaled_workload(schema, n_statements=10, seed=1)


@pytest.fixture(scope="module")
def pool(schema):
    return [dataclasses.replace(s, name=f"p{i:02d}") for i, s in
            enumerate(make_scaled_workload(schema, n_statements=16,
                                           seed=6).statements)]


@pytest.fixture(params=BACKENDS)
def opt(request):
    return AdvisorOptions(backend=request.param, device="cpu")


def assert_identical(rec_s, rec_f):
    assert rec_s.config == rec_f.config
    assert rec_s.cost == rec_f.cost
    assert rec_s.used_bytes == rec_f.used_bytes


def names(wl: Workload):
    return [s.name for s in wl.statements]


def drain_recommend(fleet, tid, budget=BUDGET):
    t = fleet.submit_recommend(tid, budget)
    fleet.run_until_drained()
    return t.result(300)


def assert_fleet_parity(fleet, tid, opt, budget=BUDGET):
    """The recovered tenant's next recommendation == a fresh advisor on
    the recovered workload."""
    rec = drain_recommend(fleet, tid, budget)
    wl = fleet.tenants[tid].session.workload
    assert_identical(rec, DesignAdvisor(wl, opt).recommend(budget))
    return wl


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------

class TestFraming:
    def test_roundtrip(self):
        recs = [(REC_DELTA, b"hello"), (REC_ABORT, pickle.dumps(3)),
                (REC_MANIFEST, b"\x00" * 200)]
        blob = b"".join(frame_record(t, p) for t, p in recs)
        scan = scan_records(blob, ALL_TYPES)
        assert scan.records == recs
        assert scan.good_end == len(blob)
        assert not scan.torn_tail and scan.corrupt_at is None
        # a manifest is no WAL record, a delta no snapshot record
        wal = scan_records(blob, WAL_TYPES)
        assert wal.records == recs[:2] and wal.torn_tail
        snap = scan_records(blob, SNAP_TYPES)
        assert snap.records == [] and snap.corrupt_at == 0

    def test_empty(self):
        scan = scan_records(b"", WAL_TYPES)
        assert scan.records == [] and scan.good_end == 0
        assert not scan.torn_tail and scan.corrupt_at is None

    def test_torn_tail_every_prefix(self):
        """Truncating anywhere inside the final record is a torn tail,
        truncated back to the last whole record, for EVERY offset."""
        r1 = frame_record(REC_DELTA, b"first")
        r2 = frame_record(REC_DELTA, b"second record payload")
        blob = r1 + r2
        for cut in range(len(r1) + 1, len(blob)):
            scan = scan_records(blob[:cut], WAL_TYPES)
            assert scan.records == [(REC_DELTA, b"first")]
            assert scan.good_end == len(r1)
            assert scan.torn_tail and scan.corrupt_at is None

    def test_single_bit_flip_never_passes(self):
        """Flip every bit of a two-record log in turn: the scan must
        classify every flip as torn/corrupt, never parse it clean, the
        type byte included."""
        blob = frame_record(REC_DELTA, b"abcdef") + \
            frame_record(REC_ABORT, b"xy")
        clean = scan_records(blob, WAL_TYPES)
        for byte in range(len(blob)):
            for bit in range(8):
                bad = bytearray(blob)
                bad[byte] ^= 1 << bit
                scan = scan_records(bytes(bad), WAL_TYPES)
                assert scan.torn_tail or scan.corrupt_at is not None
                assert scan.records == clean.records[:len(scan.records)]
                assert len(scan.records) < len(clean.records)

    def test_mid_log_corruption_vs_torn_tail(self):
        r1 = frame_record(REC_DELTA, b"one")
        r2 = frame_record(REC_DELTA, b"two")
        # damage in r1 with r2 intact after it -> corruption at 0
        bad = bytearray(r1 + r2)
        bad[_HEADER.size] ^= 0xFF
        scan = scan_records(bytes(bad), WAL_TYPES)
        assert scan.corrupt_at == 0 and not scan.torn_tail
        assert scan.records == []
        # same damage with nothing valid after -> torn tail
        scan2 = scan_records(bytes(bad[:len(r1)]), WAL_TYPES)
        assert scan2.torn_tail and scan2.corrupt_at is None

    def test_garbage_tail_with_magic_bytes(self):
        """A torn write that happens to start with the magic must still
        be a torn tail, not corruption."""
        r1 = frame_record(REC_DELTA, b"good")
        scan = scan_records(r1 + WAL_MAGIC + b"\xff" * 7, WAL_TYPES)
        assert scan.records == [(REC_DELTA, b"good")]
        assert scan.torn_tail and scan.corrupt_at is None


# ---------------------------------------------------------------------------
# DurableStore write path + recovery
# ---------------------------------------------------------------------------

class TestDurableStore:
    def test_register_log_recover_roundtrip(self, tmp_path, pool):
        store = DurableStore(tmp_path)
        store.register("a", b"snap-a", meta={"k": 1})
        d0 = WorkloadDelta(added=(pool[0],))
        d1 = WorkloadDelta(added=(pool[1],), removed=(pool[0].name,))
        assert store.log_delta("a", d0) == 1
        assert store.log_delta("a", d1) == 2
        store.close()
        rec = DurableStore(tmp_path).recover()
        assert set(rec) == {"a"}
        rt = rec["a"]
        assert rt.snapshot_bytes == b"snap-a" and rt.meta == {"k": 1}
        assert rt.deltas == [d0, d1] and rt.last_seq == 2
        assert not rt.torn_tail and rt.error is None

    def test_abort_compensates(self, tmp_path, pool):
        store = DurableStore(tmp_path)
        store.register("a", b"s")
        store.log_delta("a", WorkloadDelta(added=(pool[0],)))
        seq = store.log_delta("a", WorkloadDelta(added=(pool[1],)))
        store.log_abort("a", seq)
        store.close()
        rt = DurableStore(tmp_path).recover()["a"]
        assert rt.deltas == [WorkloadDelta(added=(pool[0],))]
        assert rt.last_seq == 2        # aborted seqs stay consumed

    def test_checkpoint_truncates_and_bounds_replay(self, tmp_path, pool):
        store = DurableStore(tmp_path)
        store.register("a", b"v0")
        store.log_delta("a", WorkloadDelta(added=(pool[0],)))
        store.checkpoint("a", b"v1")
        assert (tmp_path / "wal" / "a.wal").stat().st_size == 0
        d2 = WorkloadDelta(added=(pool[1],))
        store.log_delta("a", d2)
        store.close()
        rt = DurableStore(tmp_path).recover()["a"]
        assert rt.snapshot_bytes == b"v1"
        assert rt.deltas == [d2]       # pre-checkpoint delta not replayed

    def test_maybe_compact_threshold_and_laziness(self, tmp_path, pool):
        store = DurableStore(tmp_path, compact_after=2)
        store.register("a", b"v0")
        calls = []

        def snap_fn():
            calls.append(1)
            return b"v1"

        store.log_delta("a", WorkloadDelta(added=(pool[0],)))
        assert store.maybe_compact("a", snap_fn) is False and not calls
        store.log_delta("a", WorkloadDelta(added=(pool[1],)))
        assert store.maybe_compact("a", snap_fn) is True and len(calls) == 1
        assert store.compactions == 1
        assert (tmp_path / "wal" / "a.wal").stat().st_size == 0

    def test_group_commit_batches_fsyncs(self, tmp_path, pool):
        store = DurableStore(tmp_path, group_commit=4)
        store.register("a", b"s")
        base = store.fsyncs
        for i in range(8):
            store.log_delta("a", WorkloadDelta(added=(pool[i],)))
        assert store.fsyncs - base == 2    # 8 appends, every 4th syncs
        store.log_delta("a", WorkloadDelta(added=(pool[8],)))
        store.sync("a")                    # force the straggler
        assert store.fsyncs - base == 3
        store.close()
        assert len(DurableStore(tmp_path).recover()["a"].deltas) == 9

    def test_duplicate_register_rejected(self, tmp_path):
        store = DurableStore(tmp_path)
        store.register("a", b"s")
        with pytest.raises(ValueError, match="already registered"):
            store.register("a", b"s2")

    def test_unknown_tenant_rejected(self, tmp_path, pool):
        store = DurableStore(tmp_path)
        with pytest.raises(KeyError, match="not registered"):
            store.log_delta("ghost", WorkloadDelta(added=(pool[0],)))

    def test_tenant_id_quoting(self, tmp_path, pool):
        """Hostile tenant ids become safe filenames and round-trip."""
        tid = "../weird/tenant id?*"
        store = DurableStore(tmp_path)
        store.register(tid, b"s")
        store.log_delta(tid, WorkloadDelta(added=(pool[0],)))
        store.close()
        for p in (tmp_path / "wal").iterdir():
            assert p.parent == tmp_path / "wal"      # no traversal
        assert set(DurableStore(tmp_path).recover()) == {tid}

    def test_torn_tail_physically_truncated(self, tmp_path, pool):
        store = DurableStore(tmp_path)
        store.register("a", b"s")
        store.log_delta("a", WorkloadDelta(added=(pool[0],)))
        store.close()
        wal = tmp_path / "wal" / "a.wal"
        good = wal.stat().st_size
        with open(wal, "ab") as f:
            f.write(b"DWAL\xff\xff")
        store2 = DurableStore(tmp_path)
        rt = store2.recover()["a"]
        assert rt.torn_tail and rt.error is None
        assert store2.torn_tail_truncations == 1
        assert wal.stat().st_size == good     # tail is gone on disk

    def test_recover_primes_store_for_more_journaling(self, tmp_path,
                                                      pool):
        store = DurableStore(tmp_path)
        store.register("a", b"s")
        store.log_delta("a", WorkloadDelta(added=(pool[0],)))
        store.close()
        store2 = DurableStore(tmp_path)
        rt = store2.recover()["a"]
        assert store2.log_delta("a", WorkloadDelta(added=(pool[1],))) \
            == rt.last_seq + 1
        store2.close()
        assert len(DurableStore(tmp_path).recover()["a"].deltas) == 2


# ---------------------------------------------------------------------------
# Crash-point harness: kill + recover at every record boundary
# ---------------------------------------------------------------------------

def run_small_storm(root, workload, pool, opt, n_deltas=3,
                    compact_after=None, faults=None):
    """Two tenants; the victim (t0) takes `n_deltas` deltas.  Returns
    the expected per-prefix workloads for t0 (index i == state after i
    deltas)."""
    store = DurableStore(root, compact_after=compact_after, faults=faults)
    fleet = AdvisorFleetService(FleetConfig(slots=2), faults=faults,
                                store=store)
    fleet.register_tenant("t0", workload, opt)
    fleet.register_tenant("t1", workload, opt)
    prefixes = [workload]
    for i in range(n_deltas):
        d = WorkloadDelta(added=(pool[i],))
        tk = fleet.submit_delta("t0", d)
        fleet.run_until_drained()
        assert tk.exception(30) is None
        prefixes.append(prefixes[-1].apply_delta(d))
    store.close()
    return prefixes


class TestCrashPointHarness:
    def test_every_record_boundary_recovers_to_exact_parity(
            self, tmp_path, workload, pool, opt):
        """Kill the store at every WAL record boundary; recovery must
        rebuild t0 at exactly the journaled prefix, with its next
        recommendation `==` a fresh DesignAdvisor on that workload, and
        t1 untouched."""
        base = tmp_path / "base"
        prefixes = run_small_storm(base, workload, pool, opt, n_deltas=3)
        bounds = DurableStore(base).wal_record_boundaries("t0")
        assert len(bounds) == 4            # 0 + one per delta record
        for i, cut in enumerate(bounds):
            trial = tmp_path / f"cut{i}"
            shutil.copytree(base, trial)
            with open(trial / "wal" / "t0.wal", "r+b") as f:
                f.truncate(cut)
            fleet = AdvisorFleetService.recover(trial)
            assert fleet.recovery_errors == {}
            wl = assert_fleet_parity(fleet, "t0", opt)
            assert names(wl) == names(prefixes[i])
            assert fleet.tenants["t1"].quarantined_at is None
            assert names(fleet.tenants["t1"].session.workload) \
                == names(workload)

    def test_mid_record_kills_truncate_to_last_boundary(
            self, tmp_path, workload, pool, opt):
        """Kills INSIDE a record land on the preceding boundary: the
        torn tail is truncated and the tenant recovers at the last
        wholly-journaled prefix."""
        base = tmp_path / "base"
        prefixes = run_small_storm(base, workload, pool, opt, n_deltas=2)
        bounds = DurableStore(base).wal_record_boundaries("t0")
        size = bounds[-1]
        cuts = sorted({bounds[1] + 1, (bounds[1] + size) // 2, size - 1})
        for i, cut in enumerate(cuts):
            assert bounds[1] < cut < size
            trial = tmp_path / f"mid{i}"
            shutil.copytree(base, trial)
            with open(trial / "wal" / "t0.wal", "r+b") as f:
                f.truncate(cut)
            store = DurableStore(trial)
            fleet = AdvisorFleetService.recover(store)
            assert fleet.recovery_errors == {}
            assert store.torn_tail_truncations == 1
            assert names(fleet.tenants["t0"].session.workload) \
                == names(prefixes[1])

    def test_bit_flip_quarantines_only_victim(self, tmp_path, workload,
                                              pool, opt):
        """Mid-log corruption, an injected silent bit flip, must
        quarantine ONLY the victim (on its last valid prefix, ready for
        readmission) while every other tenant recovers to parity."""
        root = tmp_path / "s"
        faults = FaultInjector(seed=5, specs={
            "bit_flip": FaultSpec(at=(0,))})     # first t0 append flips
        run_small_storm(root, workload, pool, opt, n_deltas=2,
                        faults=faults)
        fleet = AdvisorFleetService.recover(root)
        assert isinstance(fleet.recovery_errors["t0"], LogCorrupt)
        assert fleet.tenants["t0"].quarantined_at is not None
        with pytest.raises(TenantQuarantined):
            fleet.submit_recommend("t0", BUDGET)
        assert_fleet_parity(fleet, "t1", opt)
        # readmission restores from the valid prefix (the registration
        # snapshot: the flipped record was t0's first delta)
        fleet.readmit_tenant("t0")
        wl = assert_fleet_parity(fleet, "t0", opt)
        assert names(wl) == names(workload)

    def test_corrupt_snapshot_makes_observable_husk(self, tmp_path,
                                                    workload, pool, opt):
        root = tmp_path / "s"
        run_small_storm(root, workload, pool, opt, n_deltas=1)
        snap = root / "snap" / "t0.snap"
        data = bytearray(snap.read_bytes())
        data[len(data) // 2] ^= 0xFF
        snap.write_bytes(bytes(data))
        fleet = AdvisorFleetService.recover(root)
        assert "t0" in fleet.recovery_errors
        t0 = fleet.tenants["t0"]
        assert t0.session is None and t0.quarantined_at is not None
        # no checkpoint to readmit from -> a clear error, not a crash
        with pytest.raises(Exception, match="re-register"):
            fleet.readmit_tenant("t0")
        assert_fleet_parity(fleet, "t1", opt)

    def test_recovery_after_compaction_cycles(self, tmp_path, workload,
                                              pool, opt):
        """Parity holds when the log has been compacted mid-storm: the
        manifest covers a prefix and the WAL only the suffix."""
        root = tmp_path / "s"
        prefixes = run_small_storm(root, workload, pool, opt, n_deltas=3,
                                   compact_after=2)
        store = DurableStore(root)
        fleet = AdvisorFleetService.recover(store)
        assert fleet.recovery_errors == {}
        wl = assert_fleet_parity(fleet, "t0", opt)
        assert names(wl) == names(prefixes[3])
        # 3 deltas with compact_after=2 -> one compaction happened, so
        # the WAL holds exactly the post-compaction suffix
        assert len(store.recover()["t0"].deltas) <= 1


@pytest.fixture(scope="module")
def type_byte_storms(tmp_path_factory, workload, pool):
    """One three-delta storm directory per backend for the type-byte
    cases."""
    out = {}
    for backend in BACKENDS:
        opt = AdvisorOptions(backend=backend, device="cpu")
        root = tmp_path_factory.mktemp(f"type_byte_{backend}") / "base"
        prefixes = run_small_storm(root, workload, pool, opt, n_deltas=3)
        out[backend] = (root, prefixes)
    return out


@pytest.mark.parametrize("bit", range(8))
def test_type_byte_flip_quarantines_or_truncates(type_byte_storms, opt,
                                                 bit):
    """The record type byte lies outside the CRC.  Flipping any of its
    bits in any record of the victim's WAL turns a DELTA into a type no
    WAL holds: recovery quarantines the victim (valid records follow)
    or truncates a torn tail (the last record); the victim never
    recovers a workload that is not a prefix of its journaled history,
    and t1 is untouched."""
    root, prefixes = type_byte_storms[opt.backend]
    bounds = DurableStore(root).wal_record_boundaries("t0")
    assert len(bounds) == 4
    for r, start in enumerate(bounds[:-1]):
        trial = root.parent / f"r{r}b{bit}"
        shutil.copytree(root, trial)
        wal = trial / "wal" / "t0.wal"
        data = bytearray(wal.read_bytes())
        data[start + 6] ^= 1 << bit
        wal.write_bytes(bytes(data))
        store = DurableStore(trial)
        fleet = AdvisorFleetService.recover(store)
        t0 = fleet.tenants["t0"]
        if r < len(bounds) - 2:
            assert isinstance(fleet.recovery_errors["t0"], LogCorrupt)
            assert t0.quarantined_at is not None
        else:
            assert fleet.recovery_errors == {}
            assert store.torn_tail_truncations == 1
            assert names(t0.session.workload) == names(prefixes[r])
        assert fleet.tenants["t1"].quarantined_at is None
        shutil.rmtree(trial)


# ---------------------------------------------------------------------------
# Disk fault sites through the fleet
# ---------------------------------------------------------------------------

class TestDiskFaultSites:
    def test_short_write_is_retryable_and_replay_consistent(
            self, tmp_path, workload, pool, opt):
        faults = FaultInjector(seed=3, specs={
            "disk_write": FaultSpec(at=(1,))})
        store = DurableStore(tmp_path, faults=faults)
        fleet = AdvisorFleetService(FleetConfig(slots=1), faults=faults,
                                    store=store)
        fleet.register_tenant("t0", workload, opt)
        tks = [fleet.submit_delta("t0", WorkloadDelta(added=(pool[i],)))
               for i in range(3)]
        fleet.run_until_drained()
        assert all(t.exception(30) is None for t in tks)
        assert fleet.stats["retries"] == 1
        assert store.short_writes_injected == 1
        store.close()
        f2 = AdvisorFleetService.recover(tmp_path)
        assert f2.recovery_errors == {}
        wl = assert_fleet_parity(f2, "t0", opt)
        assert len(wl.statements) == len(workload.statements) + 3

    def test_fsync_failure_appends_abort_then_retry_succeeds(
            self, tmp_path, workload, pool, opt):
        faults = FaultInjector(seed=3, specs={
            "fsync": FaultSpec(at=(1,))})
        store = DurableStore(tmp_path, faults=faults)
        fleet = AdvisorFleetService(FleetConfig(slots=1), faults=faults,
                                    store=store)
        fleet.register_tenant("t0", workload, opt)
        tks = [fleet.submit_delta("t0", WorkloadDelta(added=(pool[i],)))
               for i in range(3)]
        fleet.run_until_drained()
        assert all(t.exception(30) is None for t in tks)
        assert store.wal_aborts == 1
        store.close()
        # the aborted seq is skipped, the retried journal entry applies:
        # exactly 3 deltas land despite 4 DELTA records in history
        rt = DurableStore(tmp_path).recover()["t0"]
        assert len(rt.deltas) == 3
        f2 = AdvisorFleetService.recover(tmp_path)
        wl = assert_fleet_parity(f2, "t0", opt)
        assert len(wl.statements) == len(workload.statements) + 3

    def test_failed_apply_is_abort_compensated(self, tmp_path, workload,
                                               pool, opt):
        """A delta that journals but fails validation must not resurrect
        at recovery (the write-ahead rule's compensation path)."""
        store = DurableStore(tmp_path)
        fleet = AdvisorFleetService(FleetConfig(slots=1), store=store)
        fleet.register_tenant("t0", workload, opt)
        bad = WorkloadDelta(removed=("no_such_statement",))
        tk = fleet.submit_delta("t0", bad)
        ok = fleet.submit_delta("t0", WorkloadDelta(added=(pool[0],)))
        fleet.run_until_drained()
        assert tk.exception(30) is not None
        assert ok.exception(30) is None
        assert store.wal_aborts == 1
        store.close()
        f2 = AdvisorFleetService.recover(tmp_path)
        wl = assert_fleet_parity(f2, "t0", opt)
        assert len(wl.statements) == len(workload.statements) + 1

    def test_durability_counters_in_fleet_stats(self, tmp_path, workload,
                                                pool, opt):
        store = DurableStore(tmp_path, compact_after=2)
        fleet = AdvisorFleetService(FleetConfig(slots=1), store=store)
        fleet.register_tenant("t0", workload, opt)
        for i in range(4):
            fleet.submit_delta("t0", WorkloadDelta(added=(pool[i],)))
        fleet.run_until_drained()
        s = fleet.stats
        assert s["wal_appends"] == 4
        assert s["compactions"] == 2
        assert s["fsyncs"] > 0
        assert s["recoveries"] == 0 and s["torn_tail_truncations"] == 0
        storeless = AdvisorFleetService(FleetConfig(slots=1))
        assert storeless.stats["wal_appends"] == 0

    def test_readmit_checkpoints_durable_state(self, tmp_path, workload,
                                               pool, opt):
        """Readmission after an in-memory crash realigns the durable log
        with the restored checkpoint, so the NEXT process death recovers
        the same state the fleet actually serves."""
        store = DurableStore(tmp_path)
        fleet = AdvisorFleetService(FleetConfig(slots=1), store=store)
        fleet.register_tenant("t0", workload, opt)
        fleet.submit_delta("t0", WorkloadDelta(added=(pool[0],)))
        fleet.run_until_drained()
        fleet.crash_tenant("t0")
        fleet.readmit_tenant("t0")
        live = names(fleet.tenants["t0"].session.workload)
        store.close()
        f2 = AdvisorFleetService.recover(tmp_path)
        assert names(f2.tenants["t0"].session.workload) == live


# ---------------------------------------------------------------------------
# Byte-offset fuzz
# ---------------------------------------------------------------------------

_FUZZ_STATE = {}


def _fuzz_base(tmp_path_factory, workload, pool, opt):
    """One shared storm directory per backend for every fuzz example."""
    state = _FUZZ_STATE.get(opt.backend)
    if state is None:
        root = tmp_path_factory.mktemp(f"fuzz_{opt.backend}") / "base"
        state = _FUZZ_STATE[opt.backend] = {
            "prefixes": run_small_storm(root, workload, pool, opt,
                                        n_deltas=3),
            "root": root,
            "size": (root / "wal" / "t0.wal").stat().st_size,
            "trial": 0}
    return state


@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=25, deadline=None)
@given(offset=st.integers(min_value=0, max_value=10_000),
       flip=st.booleans(), bit=st.integers(min_value=0, max_value=7))
def test_property_arbitrary_byte_damage_never_crashes_recovery(
        tmp_path_factory, workload, pool, backend, offset, flip, bit):
    """Damage the victim WAL at an ARBITRARY byte offset (truncate
    there, or flip one bit there) and recovery must (a) never raise,
    (b) leave t1 at exact parity, and (c) leave t0 either healthy on a
    valid prefix of the journaled history or quarantined with the error
    recorded."""
    opt = AdvisorOptions(backend=backend, device="cpu")
    state = _fuzz_base(tmp_path_factory, workload, pool, opt)
    size = state["size"]
    offset = offset % (size + 1)
    state["trial"] += 1
    trial = state["root"].parent / f"t{state['trial']}"
    if trial.exists():
        shutil.rmtree(trial)
    shutil.copytree(state["root"], trial)
    wal = trial / "wal" / "t0.wal"
    if flip and offset < size:
        data = bytearray(wal.read_bytes())
        data[offset] ^= 1 << bit
        wal.write_bytes(bytes(data))
    else:
        with open(wal, "r+b") as f:
            f.truncate(offset)
    fleet = AdvisorFleetService.recover(trial)       # must not raise
    assert fleet.tenants["t1"].quarantined_at is None
    assert names(fleet.tenants["t1"].session.workload) == names(workload)
    t0 = fleet.tenants["t0"]
    if t0.quarantined_at is not None:
        assert "t0" in fleet.recovery_errors
    else:
        got = names(t0.session.workload)
        allowed = [names(p) for p in state["prefixes"]]
        assert got in allowed
    shutil.rmtree(trial)
