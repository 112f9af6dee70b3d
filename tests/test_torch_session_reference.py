"""The port's online session against the JAX package's, on the same inputs.

* numpy backend: after every round of a delta sequence the port's
  `AdvisorSession` recommends `==` the reference's numpy session, and every
  `stats` counter the two share is equal (the per-record replay is ported
  verbatim), in plain, five-codec, bounded and compressed sessions.
* torch backend on the CPU against the reference's `backend="jax"` session
  (Pallas interpret mode): the same configuration and plan each round, the
  greedy steps equal up to the float32 ping-pong (ROADMAP Queue C), cost
  within rtol 1e-6; and each round `==` a fresh torch/cpu `DesignAdvisor`.
* The pieces the session is built from: `FaultInjector` schedules
  bit-identical for the same seed, equal `schema_fingerprint`s, the
  snapshot frame byte-identical for equal payload length and CRC,
  `EstimateCache`'s LRU, `ClusterIndex.apply_delta`, the incremental
  `CostEngine` matrices and `execute_cached`'s estimates.
"""
import dataclasses
import math
import zlib

import numpy as np
import pytest

import repro.core as rc
from repro.core import session as ref_session
from repro.core.estimation_engine import EstimationEngine as RefEstEngine
from repro.core.estimation_graph import EstimationPlanner as RefPlanner
import repro_torch.core as pt
from repro_torch.core import session as port_session
from repro_torch.core.estimation_graph import EstimationPlanner
from torch_port_util import (assert_same_steps_up_to_ping_pong, labels,
                             port_schema, port_workload, statement_spec)

FIVE = ("NS", "GDICT", "LDICT", "PREFIX", "RLE")
BUDGET = 2_000_000          # tests/test_backend_unified.py's


@pytest.fixture(scope="module")
def ref_schema():
    return rc.make_tpch_like(scale=0.15, z=0, seed=0)


@pytest.fixture(scope="module")
def schema(ref_schema):
    return port_schema(ref_schema)


@pytest.fixture(scope="module")
def ref_workload(ref_schema):
    return rc.make_scaled_workload(ref_schema, n_statements=30, seed=2)


@pytest.fixture(scope="module")
def ref_pool(ref_schema):
    return [dataclasses.replace(s, name=f"d{i:03d}") for i, s in
            enumerate(rc.make_scaled_workload(ref_schema, n_statements=20,
                                              seed=9).statements)]


@pytest.fixture(scope="module")
def budget(ref_schema, ref_workload):
    adv = rc.DesignAdvisor(ref_workload)
    return 0.3 * sum(adv.sizes.size(i)
                     for i in rc.base_configuration(ref_schema).indexes)


def port_statements(ref_stmts, schema):
    return port_workload(rc.Workload(schema=None, statements=list(ref_stmts)),
                         schema).statements


def ref_deltas(wl, pool):
    names = [s.name for s in wl.statements]
    return [
        rc.WorkloadDelta(added=tuple(pool[0:3])),
        rc.WorkloadDelta(removed=(names[5], names[11]),
                         reweighted=((names[0], 4.0), (names[1], 0.25))),
        rc.WorkloadDelta(reweighted=((names[3], 2.5),)),
        rc.WorkloadDelta(added=tuple(pool[3:6]),
                         removed=(names[2], "d000"),
                         reweighted=((names[4], 2.0),)),
    ]


def port_delta(d, schema):
    return pt.WorkloadDelta(added=tuple(port_statements(d.added, schema)),
                            removed=d.removed, reweighted=d.reweighted)


def assert_same_rec(got, want):
    assert labels(got.config) == labels(want.config)
    assert (got.cost, got.used_bytes, got.base_cost, got.steps) == \
        (want.cost, want.used_bytes, want.base_cost, want.steps)
    assert (got.n_sampled, got.n_deduced, got.estimation_cost_pages,
            got.pool_size, got.candidate_count) == \
        (want.n_sampled, want.n_deduced, want.estimation_cost_pages,
         want.pool_size, want.candidate_count)
    assert (got.compression_error_bound, got.n_representatives) == \
        (want.compression_error_bound, want.n_representatives)


SESSIONS = {
    "dtac": {},
    "five-codecs": dict(methods=FIVE),
    "tight": dict(samplecf_cache_entries=8, max_planner_nodes=60,
                  max_replay_entries=40),
    "compressed": dict(compression_budget=12),
}


@pytest.mark.parametrize("variant", list(SESSIONS))
def test_numpy_session_equals_reference_session(ref_workload, ref_pool,
                                                schema, budget, variant):
    kw = SESSIONS[variant]
    ref = rc.AdvisorSession(ref_workload,
                            rc.AdvisorOptions(backend="numpy", **kw))
    got = pt.AdvisorSession(port_workload(ref_workload, schema),
                            pt.AdvisorOptions(backend="numpy", **kw))
    deltas = [None] + ref_deltas(ref_workload, ref_pool)
    for d in deltas:
        if d is not None:
            ref.apply(d)
            got.apply(port_delta(d, schema))
        assert_same_rec(got.recommend(budget), ref.recommend(budget))
        want_stats, got_stats = ref.stats, got.stats
        assert set(got_stats) == set(want_stats)
        assert got_stats == want_stats
        assert [statement_spec(s) for s in got.workload.statements] == \
            [statement_spec(s) for s in ref.workload.statements]


@pytest.fixture(scope="module")
def jax_rounds(ref_schema):
    """The reference's jax-backend session (tests/test_backend_unified.py's
    shape): 12 statements, then 3 rounds of 2 added; per round its
    recommendation and the workload after it."""
    opt = rc.AdvisorOptions(backend="jax")
    wl = rc.make_scaled_workload(ref_schema, n_statements=12, seed=11)
    sess = rc.AdvisorSession(wl, opt)
    rounds = [(wl, None, sess.recommend(BUDGET))]
    for rnd in range(3):
        extra = rc.make_scaled_workload(ref_schema, n_statements=2,
                                        seed=300 + rnd)
        added = tuple(dataclasses.replace(s, name=f"r{rnd}_{s.name}")
                      for s in extra.statements)
        sess.add_statements(added)
        wl = wl.apply_delta(rc.WorkloadDelta(added=added))
        rounds.append((wl, added, sess.recommend(BUDGET)))
    return rounds


def test_torch_cpu_session_equals_reference_jax_session(jax_rounds, schema):
    opt = pt.AdvisorOptions(backend="torch", device="cpu")
    sess = None
    for wl, added, want in jax_rounds:
        if sess is None:
            sess = pt.AdvisorSession(port_workload(wl, schema), opt)
        else:
            sess.add_statements(port_statements(added, schema))
        got = sess.recommend(BUDGET)
        fresh = pt.DesignAdvisor(sess.workload, opt).recommend(BUDGET)
        assert (got.config, got.cost, got.used_bytes, got.steps) == \
            (fresh.config, fresh.cost, fresh.used_bytes, fresh.steps)
        assert labels(got.config) == labels(want.config)
        assert_same_steps_up_to_ping_pong(got.steps, want.steps)
        assert (got.estimation_plan.f, got.n_sampled, got.n_deduced) == \
            (want.estimation_plan.f, want.n_sampled, want.n_deduced)
        assert math.isclose(got.cost, want.cost, rel_tol=1e-6)
        assert (got.pool_size, got.candidate_count) == \
            (want.pool_size, want.candidate_count)


@pytest.mark.parametrize("seed", [0, 7, 11, 12, 1234])
def test_fault_schedules_equal_reference(seed):
    specs = {"estimation": 0.2, "costing": 0.35, "planner_replay": 0.5,
             "apply_delta": 0.1, "prefetch": 0.05}
    scripted = {"apply_delta": ((1, 4), 0.1, None),
                "costing": ((0,), 0.35, 3)}
    ref = rc.FaultInjector(seed=seed, specs=dict(specs, **{
        s: rc.FaultSpec(rate=r, at=at, max_fires=mx)
        for s, (at, r, mx) in scripted.items()}))
    got = pt.FaultInjector(seed=seed, specs=dict(specs, **{
        s: pt.FaultSpec(rate=r, at=at, max_fires=mx)
        for s, (at, r, mx) in scripted.items()}))
    order = np.random.default_rng(seed).choice(len(rc.faults.SITES), 600)
    sites = [rc.faults.SITES[i] for i in order]
    assert [got.fires(s) for s in sites] == [ref.fires(s) for s in sites]
    assert got.stats() == ref.stats()
    assert pt.faults.SITES == rc.faults.SITES


@pytest.mark.parametrize("scale, z, sample_seed", [(0.1, 0.0, 0),
                                                    (0.15, 1.0, 3)])
def test_schema_fingerprint_equals_reference(scale, z, sample_seed):
    ref = rc.make_tpch_like(scale=scale, z=z, seed=0)
    own = pt.make_tpch_like(scale=scale, z=z, seed=0)
    want = rc.samplecf.schema_fingerprint(ref, sample_seed)
    assert pt.samplecf.schema_fingerprint(own, sample_seed) == want
    assert pt.samplecf.schema_fingerprint(port_schema(ref),
                                          sample_seed) == want
    assert pt.samplecf.schema_fingerprint(own, sample_seed + 1) != want


@pytest.mark.parametrize("length", [0, 1, 4096, 2 ** 31 + 5])
def test_snapshot_header_equals_reference(length):
    crc = zlib.crc32(length.to_bytes(8, "little"))
    assert port_session.SNAPSHOT_MAGIC == ref_session.SNAPSHOT_MAGIC
    assert port_session.SNAPSHOT_FORMAT_VERSION == \
        ref_session.SNAPSHOT_FORMAT_VERSION
    assert port_session._SNAP_HEADER.pack(
        port_session.SNAPSHOT_MAGIC, port_session.SNAPSHOT_FORMAT_VERSION,
        length, crc) == ref_session._SNAP_HEADER.pack(
        ref_session.SNAPSHOT_MAGIC, ref_session.SNAPSHOT_FORMAT_VERSION,
        length, crc)


def test_reference_accepts_the_port_snapshot_frame(ref_workload, schema):
    """The reference validates the port's frame (magic, version, length,
    CRC) and stops only at the payload's class, which is the port's."""
    blob = pt.AdvisorSession(port_workload(ref_workload, schema),
                             pt.AdvisorOptions(backend="numpy")
                             ).snapshot().to_bytes()
    hdr = ref_session._SNAP_HEADER
    magic, version, length, crc = hdr.unpack_from(blob, 0)
    assert (magic, version, length) == (ref_session.SNAPSHOT_MAGIC,
                                        ref_session.SNAPSHOT_FORMAT_VERSION,
                                        len(blob) - hdr.size)
    assert crc == zlib.crc32(blob[hdr.size:])
    with pytest.raises(TypeError, match="not a SessionSnapshot"):
        rc.SessionSnapshot.from_bytes(blob)


def test_estimate_cache_equals_reference():
    ops = np.random.default_rng(5).integers(0, 12, size=(400, 2))
    caches = (rc.EstimateCache(5), pt.EstimateCache(5))
    seen = ([], [])
    for op, key in ops.tolist():
        for c, out in zip(caches, seen):
            if op < 5:
                c[key] = op
            elif op < 9:
                out.append(c.get(key))
            elif op < 11:
                out.append(key in c)
            elif key in c:
                out.append(c[key])
    assert seen[0] == seen[1]
    assert caches[1].stats() == caches[0].stats()
    assert caches[1].items() == caches[0].items()


def test_cluster_index_apply_delta_equals_reference(ref_schema, schema,
                                                    ref_workload, ref_pool):
    ref = rc.ClusterIndex.from_workload(ref_workload)
    got = pt.ClusterIndex.from_workload(port_workload(ref_workload, schema))
    wl = ref_workload
    for d in ref_deltas(ref_workload, ref_pool):
        ref.apply_delta(d)
        got.apply_delta(port_delta(d, schema))
        wl = wl.apply_delta(d)
        for budget in (6, 12):
            want = ref.derive(budget)
            have = got.derive(budget)
            fresh = pt.compress_workload(port_workload(wl, schema), budget)
            assert [statement_spec(s) for s in have.workload.statements] \
                == [statement_spec(s) for s in want.workload.statements] \
                == [statement_spec(s) for s in fresh.workload.statements]
            assert (have.n_full, have.n_representatives) == \
                (want.n_full, want.n_representatives)


ENGINE_MATRICES = ("cov", "seek", "ridr", "scanc", "upd", "q_w", "u_w",
                   "ncols_used", "u_rows")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_cost_engine_deltas_equal_reference_and_fresh(ref_schema, schema,
                                                      ref_workload, ref_pool,
                                                      device):
    """Appended, dropped and reweighted rows and refreshed columns: the
    port's incremental engine holds the reference's incremental engine's
    matrices and a fresh engine's on the resulting workload, bitwise."""
    wl = port_workload(ref_workload, schema)
    ref_sizes = rc.SizeProvider(ref_schema)
    sizes = pt.SizeProvider(schema)
    adv = pt.DesignAdvisor(wl, pt.AdvisorOptions(backend="numpy"))
    base = pt.base_configuration(schema)
    idxs = list(base.indexes) + adv._candidate_universe()[2]
    ref_idxs = [rc.IndexDef(i.table, i.cols, i.compression, i.clustered)
                for i in idxs]
    for k, (i, r) in enumerate(zip(idxs, ref_idxs)):
        if i.compression is not None:
            sizes.register(i, 1000.0 + 37 * k)
            ref_sizes.register(r, 1000.0 + 37 * k)
    ref = rc.CostEngine(ref_workload, ref_sizes)
    dev = None if device is None else pt.resolve_device("torch", device)
    got = pt.CostEngine(wl, sizes, device=dev)
    ref.register(ref_idxs)
    got.register(idxs)
    rwl = ref_workload
    for d in ref_deltas(ref_workload, ref_pool):
        ref.apply_delta(d)
        got.apply_delta(port_delta(d, schema))
        rwl = rwl.apply_delta(d)
        # a re-estimated size: the column is refilled, not appended
        j = next(k for k, i in enumerate(idxs) if i.compression is not None)
        sizes.register(idxs[j], 5000.0 + len(rwl.statements))
        ref_sizes.register(ref_idxs[j], 5000.0 + len(rwl.statements))
        assert got.sync_sizes() == ref.sync_sizes()
        fresh = pt.CostEngine(port_workload(rwl, schema), sizes)
        fresh.register(idxs)
        for t in got.blocks:
            b, want, f = got.blocks[t], ref.blocks[t], fresh.blocks[t]
            n = b.n
            assert n == want.n == f.n
            for name in ENGINE_MATRICES:
                mine = getattr(b, name)
                ref_m = getattr(want, name)
                fresh_m = getattr(f, name)
                if mine.ndim == 2:
                    mine, ref_m, fresh_m = (m[:, :n] for m in
                                            (mine, ref_m, fresh_m))
                np.testing.assert_array_equal(mine, ref_m)
                np.testing.assert_array_equal(mine, fresh_m)
        got_stats = got.stats()
        assert got_stats == {k: v for k, v in ref.stats().items()
                             if k in got_stats}
        q = next(s for s in got.workload.statements
                 if isinstance(s, pt.Query))
        cands = [i for i in idxs if i.table == q.table]
        np.testing.assert_array_equal(
            got.candidate_query_costs(q, base, cands),
            pt.CostEngine(got.workload, sizes, device=dev)
            .candidate_query_costs(q, base, cands))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_execute_cached_equals_reference(ref_schema, schema, ref_workload,
                                         device):
    """Cached execution estimates exactly what the reference's does, with
    only the misses sampled, through a cache too small for the plan."""
    adv = rc.DesignAdvisor(ref_workload, rc.AdvisorOptions(methods=FIVE))
    ref_targets = list(adv.estimation_targets(adv.generate_candidates()))
    targets = [pt.NodeKey(k.table, k.cols, k.method) for k in ref_targets]
    ref_planner = RefPlanner(ref_schema.tables, record=False)
    ref_plan = ref_planner.plan(ref_targets, 0.5, 0.9)
    manager = rc.SampleManager(ref_schema.tables, seed=0)
    want = ref_planner.execute_cached(
        ref_plan, manager, rc.EstimateCache(4),
        engine=RefEstEngine(ref_schema.tables, manager))
    # the port's numpy planner gives the reference's plan; the engine
    # estimates on the device
    planner = EstimationPlanner(schema.tables)
    plan = planner.plan(targets, 0.5, 0.9)
    assert (plan.f, plan.n_sampled(), plan.total_cost) == \
        (ref_plan.f, ref_plan.n_sampled(), ref_plan.total_cost)
    dev = None if device is None else pt.resolve_device("torch", device)
    engine = pt.EstimationEngine(schema.tables,
                                 pt.SampleManager(schema.tables, seed=0),
                                 device=dev)
    cache = pt.EstimateCache(4)
    got = planner.execute_cached(plan, cache, engine)
    again = planner.execute_cached(plan, cache, engine)
    assert engine.targets_estimated == 2 * plan.n_sampled() - 4
    for k, est in want.items():
        mine = got[pt.NodeKey(k.table, k.cols, k.method)]
        assert (mine.est_bytes, mine.method, mine.cost_pages, mine.cf) == \
            (est.est_bytes, est.method, est.cost_pages, est.cf)
        assert again[pt.NodeKey(k.table, k.cols, k.method)].est_bytes == \
            est.est_bytes
