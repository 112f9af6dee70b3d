"""The port's faults, checkpoint / restore and bounded caches, with the
exact-parity contract holding THROUGH all of them (the twin of
tests/test_faults.py).

1. `FaultInjector` schedules are pure functions of (seed, site, per-site
   check index), reproducible and independent of cross-site interleaving
   (pinned to the JAX package's literals), and every instrumented session
   call fails BEFORE mutating state, so a faulted operation is cleanly
   retryable and the retried session stays `==` a fresh `DesignAdvisor`.
2. `AdvisorSession.snapshot()/restore()` round-trips (including through
   `to_bytes`/`from_bytes`) rebuild a session whose next recommendation is
   exactly `==` a fresh advisor on the snapshot workload.
3. The bounded-memory knobs (`samplecf_cache_entries`,
   `max_planner_nodes`, `max_replay_entries`) only ever discard
   recomputable state.

Every session-level test runs on the numpy backend and on the torch
backend on the CPU (`opt` fixture); snapshots are taken with
`device="cpu"`, the only device this host has.
"""
import dataclasses
import pickle

import pytest

from repro_torch.core import (AdvisorOptions, AdvisorSession, DesignAdvisor,
                              EstimateCache, FaultError, FaultInjector,
                              FaultSpec, SessionSnapshot, SnapshotCorrupt,
                              WorkloadDelta, base_configuration,
                              make_scaled_workload, make_tpch_like)
from repro_torch.core.faults import SITES
from repro_torch.core.session import (SNAPSHOT_FORMAT_VERSION,
                                      SNAPSHOT_MAGIC, _SNAP_HEADER)

BACKENDS = ["numpy", "torch"]


@pytest.fixture(scope="module")
def schema():
    return make_tpch_like(scale=0.1, z=0, seed=0)


@pytest.fixture(scope="module")
def workload(schema):
    return make_scaled_workload(schema, n_statements=14, seed=1)


@pytest.fixture(scope="module")
def pool(schema):
    return [dataclasses.replace(s, name=f"p{i:02d}") for i, s in
            enumerate(make_scaled_workload(schema, n_statements=24,
                                           seed=6).statements)]


@pytest.fixture(scope="module")
def budget(schema, workload):
    adv = DesignAdvisor(workload, AdvisorOptions(backend="numpy"))
    base = sum(adv.sizes.size(i)
               for i in base_configuration(schema).indexes)
    return 0.3 * base


@pytest.fixture(params=BACKENDS)
def opt(request):
    return AdvisorOptions(backend=request.param, device="cpu")


def assert_identical(rec_s, rec_f):
    assert rec_s.config == rec_f.config
    assert rec_s.cost == rec_f.cost
    assert rec_s.used_bytes == rec_f.used_bytes


# Tight-enough-to-evict bounds used throughout: small caches force
# evictions on every drift round while parity must not budge.
TIGHT = dict(samplecf_cache_entries=8, max_planner_nodes=20,
             max_replay_entries=10)


def tight(opt):
    return dataclasses.replace(opt, **TIGHT)


# ---------------------------------------------------------------------------
# FaultInjector determinism
# ---------------------------------------------------------------------------

class TestFaultInjector:
    def test_same_seed_same_schedule(self):
        specs = {"estimation": 0.2, "apply_delta": 0.1}
        a = FaultInjector(seed=7, specs=specs)
        b = FaultInjector(seed=7, specs=specs)
        sched_a = [(s, a.fires(s)) for _ in range(100) for s in SITES]
        sched_b = [(s, b.fires(s)) for _ in range(100) for s in SITES]
        assert sched_a == sched_b
        assert a.stats() == b.stats()
        assert a.fired["estimation"] > 0     # the rate actually bites

    def test_different_seed_different_schedule(self):
        a = FaultInjector(seed=1, specs={"estimation": 0.2})
        b = FaultInjector(seed=2, specs={"estimation": 0.2})
        assert [a.fires("estimation") for _ in range(200)] != \
               [b.fires("estimation") for _ in range(200)]

    def test_site_streams_independent_of_interleaving(self):
        """A site's fault schedule depends only on its OWN check count."""
        specs = {"estimation": 0.25, "costing": 0.25}
        solo = FaultInjector(seed=3, specs=specs)
        mixed = FaultInjector(seed=3, specs=specs)
        got_solo = [solo.fires("estimation") for _ in range(64)]
        got_mixed = []
        for i in range(64):
            for _ in range(i % 3):           # varying noise at other sites
                mixed.fires("costing")
            got_mixed.append(mixed.fires("estimation"))
        assert got_solo == got_mixed

    def test_scripted_at_indices(self):
        inj = FaultInjector(specs={"apply_delta": FaultSpec(at=(0, 3))})
        assert [inj.fires("apply_delta") for _ in range(6)] == \
               [True, False, False, True, False, False]

    def test_at_does_not_shift_rate_stream(self):
        """Scripted hits draw from the stream anyway, so adding `at`
        never changes which OTHER checks fire."""
        plain = FaultInjector(seed=5, specs={"estimation": 0.3})
        scripted = FaultInjector(
            seed=5, specs={"estimation": FaultSpec(rate=0.3, at=(4,))})
        a = [plain.fires("estimation") for _ in range(40)]
        b = [scripted.fires("estimation") for _ in range(40)]
        assert b[4] is True
        assert [x for i, x in enumerate(a) if i != 4] == \
               [x for i, x in enumerate(b) if i != 4]

    def test_max_fires_caps_total(self):
        inj = FaultInjector(specs={
            "prefetch": FaultSpec(at=tuple(range(10)), max_fires=3)})
        fires = [inj.fires("prefetch") for _ in range(10)]
        assert sum(fires) == 3 and fires[:3] == [True] * 3
        assert inj.fired["prefetch"] == 3
        assert inj.checks["prefetch"] == 10

    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError, match="unknown fault site"):
            FaultInjector(specs={"no_such_site": 0.5})

    def test_check_raises_fault_error(self):
        inj = FaultInjector(specs={"costing": FaultSpec(at=(1,))})
        inj.check("costing")                  # check 0: quiet
        with pytest.raises(FaultError, match="costing") as ei:
            inj.check("costing", "during recommend")
        assert ei.value.site == "costing" and ei.value.n == 1
        assert "during recommend" in str(ei.value)

    # The JAX package's pinned schedules for seed=7 at rate 0.5: the port
    # seeds each site's stream as it does -- (seed, crc32(site)) -- so
    # the literals are the same
    LEGACY_SITES = ("estimation", "costing", "planner_replay", "prefetch",
                    "apply_delta")
    PINNED_SEED7_RATE50 = {
        "estimation": "101100011101101100111010",
        "costing": "110011101001000100000000",
        "planner_replay": "000001111000011101111010",
        "prefetch": "000011100010101010100011",
        "apply_delta": "110001100010100111011000",
    }

    def test_legacy_schedules_pinned(self):
        inj = FaultInjector(seed=7,
                            specs={s: 0.5 for s in self.LEGACY_SITES})
        got = {s: "".join("1" if inj.fires(s) else "0"
                          for _ in range(24))
               for s in self.LEGACY_SITES}
        assert got == self.PINNED_SEED7_RATE50

    def test_disk_sites_do_not_shift_legacy_schedules(self):
        """Enabling (and exercising) the disk sites leaves the legacy
        sites' draws untouched — same literals as the pinned test."""
        specs = {s: 0.5 for s in self.LEGACY_SITES}
        specs.update({"disk_write": 0.5, "fsync": 0.5, "bit_flip": 0.5})
        inj = FaultInjector(seed=7, specs=specs)
        got = {}
        for s in self.LEGACY_SITES:
            bits = []
            for i in range(24):
                # noisy interleaved disk-site checks between every draw
                for d in ("disk_write", "fsync", "bit_flip")[:i % 4]:
                    inj.fires(d)
                bits.append("1" if inj.fires(s) else "0")
            got[s] = "".join(bits)
        assert got == self.PINNED_SEED7_RATE50

    def test_disk_sites_registered(self):
        assert SITES[-3:] == ("disk_write", "fsync", "bit_flip")
        inj = FaultInjector(specs={"disk_write": FaultSpec(at=(0,))})
        assert inj.fires("disk_write") is True
        assert inj.fires("fsync") is False   # unspecced sites still count
        assert inj.checks["fsync"] == 1


# ---------------------------------------------------------------------------
# EstimateCache (bounded LRU) semantics
# ---------------------------------------------------------------------------

class TestEstimateCache:
    def test_rejects_nonpositive_maxsize(self):
        with pytest.raises(ValueError):
            EstimateCache(0)

    def test_lru_eviction_order(self):
        c = EstimateCache(2)
        c["a"] = 1
        c["b"] = 2
        assert c["a"] == 1                    # touch: a is now most recent
        c["c"] = 3                            # evicts b, the LRU entry
        assert "b" not in c and "a" in c and "c" in c
        assert c.evictions == 1

    def test_counters_and_pure_contains(self):
        c = EstimateCache(2)
        c["a"] = 1
        c["b"] = 2
        assert c.get("a") == 1 and c.get("zz") is None
        assert (c.hits, c.misses) == (1, 1)       # get("a") made "b" LRU
        # __contains__ is a pure peek: no counters, no recency touch
        assert "b" in c
        assert (c.hits, c.misses) == (1, 1)
        c["c"] = 3
        assert "b" not in c and "a" in c
        st = c.stats()
        assert st["maxsize"] == 2 and st["evictions"] == 1

    def test_mutable_mapping_protocol(self):
        c = EstimateCache(4)
        c.update({"x": 1, "y": 2})
        assert len(c) == 2 and sorted(c) == ["x", "y"]
        del c["x"]
        assert "x" not in c and len(c) == 1


# ---------------------------------------------------------------------------
# Session fault sites: fail-before-mutate, so retries are exact
# ---------------------------------------------------------------------------

class TestSessionFaults:
    def test_faulted_apply_leaves_session_retryable(self, workload, pool,
                                                    budget, opt):
        inj = FaultInjector(specs={"apply_delta": FaultSpec(at=(0,))})
        sess = AdvisorSession(workload, opt, faults=inj)
        delta = WorkloadDelta(added=(pool[0],))
        v0 = sess.workload_version
        with pytest.raises(FaultError, match="apply_delta"):
            sess.apply(delta)
        assert sess.workload_version == v0          # untouched
        sess.apply(delta)                           # plain retry works
        fresh = DesignAdvisor(workload.apply_delta(delta), opt)
        assert_identical(sess.recommend(budget), fresh.recommend(budget))

    def test_faulted_recommend_retries_exactly(self, workload, budget, opt):
        for site in ("estimation", "costing"):
            inj = FaultInjector(specs={site: FaultSpec(at=(0,))})
            sess = AdvisorSession(workload, opt, faults=inj)
            with pytest.raises(FaultError, match=site):
                sess.recommend(budget)
            assert_identical(sess.recommend(budget),
                             DesignAdvisor(workload, opt).recommend(budget))

    def test_replay_loss_is_bit_exact(self, workload, pool, budget, opt):
        """A planner_replay fire silently drops the replay store — the
        next recommend recomputes every decision identically."""
        inj = FaultInjector(
            specs={"planner_replay": FaultSpec(at=(1, 2))})
        sess = AdvisorSession(workload, opt, faults=inj)
        plain = AdvisorSession(workload, opt)
        assert_identical(sess.recommend(budget), plain.recommend(budget))
        delta = WorkloadDelta(added=(pool[3],))
        sess.apply(delta)
        plain.apply(delta)
        assert_identical(sess.recommend(budget), plain.recommend(budget))
        st = sess.stats
        assert st["replay_faults"] >= 1

    def test_fault_storm_schedule_reproducible(self, workload, pool,
                                               budget, opt):
        """Two identical sessions under the same seeded storm fail at the
        same operations, and every SURVIVING recommend is `==` the fresh
        advisor."""
        def run(seed):
            inj = FaultInjector(seed=seed, specs={
                "apply_delta": 0.3, "estimation": 0.3, "costing": 0.3})
            sess = AdvisorSession(workload, opt, faults=inj)
            wl, outcomes = workload, []
            for i in range(6):
                delta = WorkloadDelta(added=(pool[6 + i],))
                try:
                    sess.apply(delta)
                    wl = wl.apply_delta(delta)
                    outcomes.append("d-ok")
                except FaultError:
                    outcomes.append("d-fault")
                try:
                    rec = sess.recommend(budget)
                    assert_identical(
                        rec, DesignAdvisor(wl, opt).recommend(budget))
                    outcomes.append("r-ok")
                except FaultError:
                    outcomes.append("r-fault")
            return outcomes
        a, b = run(11), run(11)
        assert a == b
        assert "d-fault" in a and "r-fault" in a and "r-ok" in a
        assert run(12) != a


# ---------------------------------------------------------------------------
# Checkpoint / restore parity
# ---------------------------------------------------------------------------

class TestSnapshotRestore:
    def _drifted(self, workload, pool, opt, faults=None):
        sess = AdvisorSession(workload, opt, faults=faults)
        sess.apply(WorkloadDelta(added=(pool[0], pool[1])))
        sess.apply(WorkloadDelta(
            removed=(workload.statements[2].name,),
            reweighted=((workload.statements[0].name, 4.0),)))
        return sess

    def test_restore_equals_fresh_advisor(self, workload, pool, budget,
                                          opt):
        sess = self._drifted(workload, pool, opt)
        rec_live = sess.recommend(budget)
        snap = sess.snapshot()
        back = AdvisorSession.restore(snap)
        rec_back = back.recommend(budget)
        fresh = DesignAdvisor(snap.workload, opt).recommend(budget)
        assert_identical(rec_back, fresh)
        assert_identical(rec_back, rec_live)

    def test_restore_without_estimates_still_exact(self, workload, pool,
                                                   budget, opt):
        sess = self._drifted(workload, pool, opt)
        sess.recommend(budget)
        snap = sess.snapshot(include_estimates=False)
        assert snap.estimates == {}
        back = AdvisorSession.restore(snap)
        assert_identical(back.recommend(budget),
                         DesignAdvisor(snap.workload, opt).recommend(budget))

    def test_bytes_round_trip(self, workload, pool, budget, opt):
        sess = self._drifted(workload, pool, opt)
        sess.recommend(budget)
        blob = sess.snapshot().to_bytes()
        assert isinstance(blob, bytes)
        # a snapshot holds SizeEstimates and the options, no tensor
        assert b"_rebuild_tensor" not in blob
        back = AdvisorSession.restore(SessionSnapshot.from_bytes(blob))
        assert_identical(back.recommend(budget),
                         DesignAdvisor(back.workload, opt).recommend(budget))

    def test_from_bytes_rejects_non_snapshot(self):
        """Unframed bytes fail the magic check (SnapshotCorrupt); a
        correctly framed payload that is not a SessionSnapshot still
        raises the original TypeError."""
        import zlib
        with pytest.raises(SnapshotCorrupt, match="magic"):
            SessionSnapshot.from_bytes(pickle.dumps({"nope": 1}))
        payload = pickle.dumps({"nope": 1})
        framed = _SNAP_HEADER.pack(SNAPSHOT_MAGIC, SNAPSHOT_FORMAT_VERSION,
                                   len(payload), zlib.crc32(payload)) \
            + payload
        with pytest.raises(TypeError, match="not a SessionSnapshot"):
            SessionSnapshot.from_bytes(framed)

    def test_snapshot_header_truncation_detected(self, workload, opt):
        blob = AdvisorSession(workload, opt).snapshot().to_bytes()
        for cut in (0, 5, _SNAP_HEADER.size - 1):
            with pytest.raises(SnapshotCorrupt, match="truncated"):
                SessionSnapshot.from_bytes(blob[:cut])
        with pytest.raises(SnapshotCorrupt, match="truncated") as ei:
            SessionSnapshot.from_bytes(blob[:len(blob) // 2])
        assert ei.value.offset == len(blob) // 2

    def test_snapshot_tamper_detected_with_checksums(self, workload, opt):
        blob = bytearray(AdvisorSession(workload, opt).snapshot().to_bytes())
        blob[_SNAP_HEADER.size + 7] ^= 0x40
        with pytest.raises(SnapshotCorrupt, match="checksum") as ei:
            SessionSnapshot.from_bytes(bytes(blob))
        assert ei.value.expected_crc is not None
        assert ei.value.actual_crc is not None
        assert ei.value.expected_crc != ei.value.actual_crc
        # the message carries both sums for the operator
        assert f"{ei.value.expected_crc:#010x}" in str(ei.value)
        assert f"{ei.value.actual_crc:#010x}" in str(ei.value)

    def test_snapshot_version_mismatch_names_both(self, workload, opt):
        blob = AdvisorSession(workload, opt).snapshot().to_bytes()
        magic, version, length, crc = _SNAP_HEADER.unpack_from(blob, 0)
        future = _SNAP_HEADER.pack(magic, version + 41, length, crc) \
            + blob[_SNAP_HEADER.size:]
        with pytest.raises(SnapshotCorrupt) as ei:
            SessionSnapshot.from_bytes(future)
        assert str(version + 41) in str(ei.value)
        assert str(SNAPSHOT_FORMAT_VERSION) in str(ei.value)

    def test_retired_names_survive_restore(self, workload, pool, opt):
        sess = AdvisorSession(workload, opt)
        gone = workload.statements[1]
        sess.apply(WorkloadDelta(removed=(gone.name,)))
        back = AdvisorSession.restore(sess.snapshot())
        with pytest.raises(ValueError, match="cannot be reused"):
            back.apply(WorkloadDelta(added=(gone,)))

    def test_restore_then_keep_drifting(self, workload, pool, budget, opt):
        sess = self._drifted(workload, pool, opt)
        back = AdvisorSession.restore(sess.snapshot())
        delta = WorkloadDelta(added=(pool[4],))
        back.apply(delta)
        fresh = DesignAdvisor(back.workload, opt)
        assert_identical(back.recommend(budget), fresh.recommend(budget))

    def test_compressed_mode_snapshot(self, workload, pool, budget, opt):
        """Snapshots work across the workload-compression outer session:
        the restored outer session recommends `==` a fresh advisor at the
        same compression budget."""
        opt = dataclasses.replace(opt, compression_budget=8)
        sess = self._drifted(workload, pool, opt)
        sess.recommend(budget)
        back = AdvisorSession.restore(sess.snapshot())
        rec = back.recommend(budget)
        fresh = DesignAdvisor(back.workload, opt).recommend(budget)
        assert_identical(rec, fresh)


# ---------------------------------------------------------------------------
# Bounded caches: evictions fire, parity holds
# ---------------------------------------------------------------------------

class TestBoundedSession:
    def test_drift_under_tight_bounds_is_exact(self, workload, pool,
                                               budget, opt):
        bounded = tight(opt)
        sess = AdvisorSession(workload, bounded)
        wl = workload
        for i in range(4):
            delta = WorkloadDelta(added=(pool[2 * i], pool[2 * i + 1]),
                                  removed=(wl.statements[i].name,))
            sess.apply(delta)
            wl = wl.apply_delta(delta)
            assert_identical(sess.recommend(budget),
                             DesignAdvisor(wl, opt).recommend(budget))
        st = sess.stats
        # the bounds actually bit — recomputable state was discarded...
        assert st["samplecf_cache_evictions"] > 0
        assert st["universe_evictions"] > 0
        assert st["replay_evictions"] > 0
        # ...and the residents obey their bounds
        assert st["sampled_estimates_cached"] <= TIGHT[
            "samplecf_cache_entries"]
        assert st["samplecf_cache_maxsize"] == TIGHT[
            "samplecf_cache_entries"]
        # the replay bound is a high-water trigger, cleared at the start
        # of the next planner run once over it
        assert st["replay_evictions"] >= 1
        # epoch eviction resets the universe; it regrows freely between
        # resets
        assert st["universe_peak_nodes"] >= st["universe_nodes"]

    def test_unbounded_stats_shape(self, workload, budget, opt):
        sess = AdvisorSession(workload, opt)
        sess.recommend(budget)
        st = sess.stats
        assert st["universe_evictions"] == 0
        assert st["replay_evictions"] == 0
        assert "samplecf_cache_evictions" not in st   # plain dict cache


# ---------------------------------------------------------------------------
# Interleaved deltas x evictions x snapshot/restore.  The deterministic
# twin always runs; hypothesis widens the schedule space when installed.
# ---------------------------------------------------------------------------

def _run_interleaving(workload, pool, budget, ops, opt):
    """Execute an op schedule against a tightly-bounded session,
    checkpointing/restoring on demand, asserting exact parity at every
    recommend.  `ops` entries: "delta" | "recommend" | "roundtrip"."""
    opt = tight(opt)
    sess = AdvisorSession(workload, opt)
    wl, at = workload, 0
    for op in ops:
        if op == "delta" and at < len(pool):
            delta = WorkloadDelta(added=(pool[at],))
            at += 1
            sess.apply(delta)
            wl = wl.apply_delta(delta)
        elif op == "recommend":
            assert_identical(sess.recommend(budget),
                             DesignAdvisor(wl, opt).recommend(budget))
        elif op == "roundtrip":
            sess = AdvisorSession.restore(
                SessionSnapshot.from_bytes(sess.snapshot().to_bytes()))
            assert [s.name for s in sess.workload.statements] == \
                   [s.name for s in wl.statements]
    assert_identical(sess.recommend(budget),
                     DesignAdvisor(wl, opt).recommend(budget))


def test_interleaved_evictions_and_restores_deterministic(
        workload, pool, budget, opt):
    ops = ["delta", "recommend", "delta", "delta", "roundtrip",
           "recommend", "delta", "roundtrip", "delta", "recommend",
           "roundtrip", "recommend"]
    _run_interleaving(workload, pool, budget, ops, opt)


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:       # pragma: no cover - CI installs hypothesis
    HAVE_HYPOTHESIS = False

    def _noop(*a, **k):
        def deco(fn):
            return fn
        return deco
    given = settings = _noop

    class st:             # minimal stand-in so the decorators parse
        @staticmethod
        def data():
            return None


@pytest.mark.skipif(not HAVE_HYPOTHESIS,
                    reason="property tests need hypothesis")
@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=6, deadline=None)
@given(st.data())
def test_property_interleaved_durability(backend, data):
    """Any interleaving of deltas, evictions (tight bounds make them
    constant) and serialized checkpoint round-trips leaves the session
    bit-identical to a fresh DesignAdvisor."""
    opt = AdvisorOptions(backend=backend, device="cpu")
    schema = make_tpch_like(scale=0.1, z=0, seed=0)
    wl = make_scaled_workload(schema, n_statements=12, seed=1)
    pool = [dataclasses.replace(s, name=f"h{i:02d}") for i, s in
            enumerate(make_scaled_workload(schema, n_statements=16,
                                           seed=8).statements)]
    base = sum(DesignAdvisor(wl, opt).sizes.size(i)
               for i in base_configuration(schema).indexes)
    ops = data.draw(st.lists(
        st.sampled_from(["delta", "recommend", "roundtrip"]),
        min_size=3, max_size=10))
    _run_interleaving(wl, pool, 0.3 * base, ops, opt)
