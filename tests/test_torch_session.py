"""The port's online advisor session: delta-sequence parity with fresh
advisors, on each backend (the twin of tests/test_session.py).

The contract: after ANY sequence of add / remove / reweight deltas,
`AdvisorSession.recommend` returns a recommendation IDENTICAL (config,
cost and used_bytes with ==, plan counts, pool) to a fresh `DesignAdvisor`
with the same options on the resulting workload.  Every parity test runs
on the numpy backend and on the torch backend on the CPU (the plain
versions of the kernels).  The replay counters are the reference's on
numpy; on torch a re-planned round is one `planner_walk` call and a
reweight-only round none.  The port has no scalar path, so the
reference's two scalar-path tests have no twin here.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (AdvisorOptions, AdvisorSession, DesignAdvisor,
                              WorkloadDelta, base_configuration,
                              make_scaled_workload, make_tpch_like,
                              make_tpch_workload)
from repro_torch.core.advisor import staged_recommend
from repro_torch.core.workload import BulkInsert
from repro_torch.kernels import planner_score as ps

BACKENDS = ["numpy", "torch"]


def options(backend, **kw):
    return AdvisorOptions(backend=backend, device="cpu", **kw)


def dtac(backend):
    return options(backend)


def dta(backend):
    return options(backend, consider_compression=False,
                   candidate_mode="topk", enumeration="pure")


@pytest.fixture(scope="module")
def schema():
    return make_tpch_like(scale=0.15, z=0, seed=0)


@pytest.fixture(scope="module")
def workload(schema):
    return make_scaled_workload(schema, n_statements=40, seed=2)


@pytest.fixture(scope="module")
def drift_pool(schema):
    return [dataclasses.replace(s, name=f"d{i:03d}") for i, s in
            enumerate(make_scaled_workload(schema, n_statements=60,
                                           seed=9).statements)]


@pytest.fixture(scope="module")
def base_size(schema, workload):
    adv = DesignAdvisor(workload, options("numpy"))
    return sum(adv.sizes.size(i) for i in base_configuration(schema).indexes)


@pytest.fixture
def walks(monkeypatch):
    """Counts `planner_walk` calls (`launch_counts()` counts CUDA launches
    only, and the CPU route launches nothing)."""
    calls = []
    walk = ps.planner_walk

    def counting(*a, **kw):
        calls.append(1)
        return walk(*a, **kw)
    monkeypatch.setattr(ps, "planner_walk", counting)
    return calls


def assert_identical(rec_s, rec_f):
    assert rec_s.config == rec_f.config
    assert rec_s.cost == rec_f.cost
    assert rec_s.used_bytes == rec_f.used_bytes
    assert rec_s.base_cost == rec_f.base_cost
    assert rec_s.n_sampled == rec_f.n_sampled
    assert rec_s.n_deduced == rec_f.n_deduced
    assert rec_s.estimation_cost_pages == rec_f.estimation_cost_pages
    assert rec_s.pool_size == rec_f.pool_size
    assert rec_s.candidate_count == rec_f.candidate_count


# ---------------------------------------------------------------------------
# Workload delta API
# ---------------------------------------------------------------------------

class TestWorkloadDelta:
    def test_apply_delta_order_semantics(self, workload, drift_pool):
        delta = WorkloadDelta(added=(drift_pool[0], drift_pool[1]),
                              removed=(workload.statements[3].name,),
                              reweighted=((workload.statements[0].name,
                                           7.5),))
        out = workload.apply_delta(delta)
        names = [s.name for s in out.statements]
        survivors = [s.name for s in workload.statements
                     if s.name != workload.statements[3].name]
        assert names == survivors + [drift_pool[0].name, drift_pool[1].name]
        assert out.statements[0].weight == 7.5
        # functional: the source workload is untouched
        assert workload.statements[0].weight != 7.5

    def test_apply_delta_validation(self, workload, drift_pool):
        with pytest.raises(KeyError):
            workload.apply_delta(WorkloadDelta(removed=("nope",)))
        with pytest.raises(KeyError):
            workload.apply_delta(WorkloadDelta(reweighted=(("nope", 1.0),)))
        with pytest.raises(ValueError):
            workload.apply_delta(WorkloadDelta(
                added=(workload.statements[0],)))   # name already taken
        name = workload.statements[1].name
        with pytest.raises(ValueError):
            workload.apply_delta(WorkloadDelta(
                removed=(name,), reweighted=((name, 1.0),)))

    def test_delta_truthiness(self):
        assert not WorkloadDelta()
        assert WorkloadDelta(removed=("x",))

    def test_duplicate_added_object_rejected(self, workload, drift_pool):
        q = drift_pool[40]
        with pytest.raises(ValueError):
            workload.apply_delta(WorkloadDelta(added=(q, q)))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_bad_delta_leaves_session_unchanged(self, workload, drift_pool,
                                                base_size, backend):
        """A delta that fails validation must not partially mutate the
        session: the next recommend still matches a fresh advisor."""
        budget = 0.25 * base_size
        opt = dtac(backend)
        sess = AdvisorSession(workload, opt)
        sess.recommend(budget)
        bad_table = dataclasses.replace(drift_pool[41], table="nope")
        for delta in (
                WorkloadDelta(removed=(workload.statements[0].name,),
                              added=(bad_table,)),
                WorkloadDelta(removed=(workload.statements[0].name,
                                       "unknown")),
                WorkloadDelta(added=(drift_pool[42], drift_pool[42]))):
            with pytest.raises((KeyError, ValueError)):
                sess.apply(delta)
        assert_identical(sess.recommend(budget),
                         DesignAdvisor(workload, opt).recommend(budget))

    def test_session_rejects_recycled_names(self, workload, drift_pool):
        sess = AdvisorSession(workload, dtac("torch"))
        gone = workload.statements[0]
        sess.remove_statements([gone.name])
        with pytest.raises(ValueError):
            sess.add_statements([gone])


def test_default_session_runs_on_the_card(workload, monkeypatch):
    """The default options ask for CUDA; without it the session raises
    instead of falling back to the CPU or NumPy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdvisorSession(workload)


# ---------------------------------------------------------------------------
# Deterministic delta-sequence parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
class TestSessionParity:
    def test_cold_recommend_matches_fresh(self, workload, base_size,
                                          backend):
        budget = 0.25 * base_size
        rec_s = AdvisorSession(workload, dtac(backend)).recommend(budget)
        rec_f = DesignAdvisor(workload, dtac(backend)).recommend(budget)
        assert_identical(rec_s, rec_f)

    def test_scripted_delta_sequence(self, workload, drift_pool, base_size,
                                     backend):
        """add -> remove -> reweight -> mixed, parity after EVERY round."""
        budget = 0.3 * base_size
        opt = dtac(backend)
        sess = AdvisorSession(workload, opt)
        sess.recommend(budget)
        wl = workload
        deltas = [
            WorkloadDelta(added=tuple(drift_pool[0:3])),
            WorkloadDelta(removed=(wl.statements[5].name,
                                   wl.statements[11].name)),
            WorkloadDelta(reweighted=((wl.statements[0].name, 4.0),
                                      (wl.statements[1].name, 0.25))),
            WorkloadDelta(added=tuple(drift_pool[3:5]),
                          removed=(wl.statements[2].name, "d000"),
                          reweighted=((wl.statements[3].name, 2.0),)),
        ]
        for delta in deltas:
            wl = wl.apply_delta(delta)
            sess.apply(delta)
            assert_identical(sess.recommend(budget),
                             DesignAdvisor(wl, opt).recommend(budget))

    def test_parity_across_budgets_after_drift(self, workload, drift_pool,
                                               base_size, backend):
        opt = dtac(backend)
        sess = AdvisorSession(workload, opt)
        sess.recommend(0.2 * base_size)
        delta = WorkloadDelta(added=tuple(drift_pool[5:8]),
                              removed=(workload.statements[7].name,))
        wl = workload.apply_delta(delta)
        sess.apply(delta)
        for frac in (0.0, 0.15, 0.5):
            assert_identical(sess.recommend(frac * base_size),
                             DesignAdvisor(wl, opt).recommend(
                                 frac * base_size))

    def test_insert_heavy_parity(self, schema, base_size, drift_pool,
                                 backend):
        wl = make_tpch_workload(schema, insert_weight=30.0)
        opt = dtac(backend)
        sess = AdvisorSession(wl, opt)
        budget = 0.4 * base_size
        sess.recommend(budget)
        delta = WorkloadDelta(
            added=(BulkInsert("ins_x", "lineitem", 500, weight=20.0),
                   drift_pool[10]),
            reweighted=(("load_orders", 5.0),))
        wl2 = wl.apply_delta(delta)
        sess.apply(delta)
        assert_identical(sess.recommend(budget),
                         DesignAdvisor(wl2, opt).recommend(budget))

    def test_dta_session_parity(self, workload, drift_pool, base_size,
                                backend):
        """No-compression sessions drift too (estimation stage is empty)."""
        opt = dta(backend)
        sess = AdvisorSession(workload, opt)
        budget = 0.3 * base_size
        sess.recommend(budget)
        delta = WorkloadDelta(added=tuple(drift_pool[20:22]),
                              removed=(workload.statements[9].name,))
        wl = workload.apply_delta(delta)
        sess.apply(delta)
        assert_identical(sess.recommend(budget),
                         DesignAdvisor(wl, opt).recommend(budget))


# ---------------------------------------------------------------------------
# Incrementality: the session must WORK less, not just match
# ---------------------------------------------------------------------------

class TestSessionIncrementality:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_counters_show_delta_proportional_work(self, workload,
                                                   drift_pool, base_size,
                                                   backend, walks):
        budget = 0.25 * base_size
        sess = AdvisorSession(workload, dtac(backend))
        sess.recommend(budget)
        cold = dict(sess.stats)
        assert cold["replay_misses"] > 0          # cold round computes
        cold_walks = len(walks)
        delta = WorkloadDelta(added=tuple(drift_pool[30:32]),
                              removed=(workload.statements[6].name,),
                              reweighted=((workload.statements[0].name,
                                           2.5),))
        sess.apply(delta)
        sess.recommend(budget)
        warm = dict(sess.stats)
        d_hits = (warm["replay_hits"] + warm["replay_verified"]
                  - cold["replay_hits"] - cold["replay_verified"])
        d_misses = warm["replay_misses"] - cold["replay_misses"]
        if backend == "numpy":
            # per-record replay: most decisions replayed
            assert (cold_walks, len(walks)) == (0, 0)
            assert d_hits > 0 and d_misses < d_hits, (d_hits, d_misses)
        else:
            # whole-plan grain: the new target set is walked once, every
            # target of it counted as recomputed
            assert (cold_walks, len(walks)) == (1, 2)
            assert d_hits == 0 and d_misses > 0
        assert warm["rec_hits"] > 0
        # statement rows were appended/dropped, not rebuilt
        assert warm["engine_rows_added"] == 2
        assert warm["engine_rows_removed"] == 1
        # SampleCF ran only for genuinely new compressed candidates
        assert warm["samplecf_cache_hits"] > 0
        # per-query selections mostly reused THIS round (the cold round
        # necessarily missed on every query)
        d_sel_hits = warm["selection_hits"] - cold["selection_hits"]
        d_sel_miss = warm["selection_misses"] - cold["selection_misses"]
        assert d_sel_hits > d_sel_miss, (d_sel_hits, d_sel_miss)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_reweight_only_round_reuses_everything(self, workload,
                                                   base_size, backend,
                                                   walks):
        budget = 0.25 * base_size
        sess = AdvisorSession(workload, dtac(backend))
        sess.recommend(budget)
        cold = dict(sess.stats)
        cold_walks = len(walks)
        sess.reweight({workload.statements[0].name: 9.0})
        sess.recommend(budget)
        warm = dict(sess.stats)
        # weights don't touch candidates, sizes, or the deduction graph
        assert warm["replay_misses"] == cold["replay_misses"]
        assert warm["samplecf_cache_misses"] == cold["samplecf_cache_misses"]
        assert warm["selection_misses"] == cold["selection_misses"]
        assert warm["engine_cols_refreshed"] == cold["engine_cols_refreshed"]
        # torch: the stored walk stands in for the round's plan
        assert len(walks) == cold_walks == (backend == "torch")
        if backend == "torch":
            assert warm["replay_hits"] - cold["replay_hits"] == \
                cold["replay_misses"]

    def test_sample_manager_is_order_independent(self, schema):
        from repro_torch.core import SampleManager
        a = SampleManager(schema.tables, seed=3)
        b = SampleManager(schema.tables, seed=3)
        # draw in different orders; contents must match per (table, f)
        sa1 = a.get_sample("orders", 0.05)
        sa2 = a.get_sample("lineitem", 0.05)
        sb2 = b.get_sample("lineitem", 0.05)
        sb1 = b.get_sample("orders", 0.05)
        for col in sa1.values:
            np.testing.assert_array_equal(sa1.values[col], sb1.values[col])
        for col in sa2.values:
            np.testing.assert_array_equal(sa2.values[col], sb2.values[col])


# ---------------------------------------------------------------------------
# Peeks and prefetched costs (tests/test_backend_unified.py's session
# tests), consumed verbatim by the next recommend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
class TestSessionPeeks:
    def test_peeked_plan_and_cost_jobs_consumed_exactly(
            self, workload, base_size, backend, walks):
        """peek_estimation_plan + peek_cost_jobs + accept_cost_results
        with the engine's own values reproduce the un-peeked
        recommendation bitwise, planning once."""
        budget = 0.3 * base_size
        opt = dtac(backend)
        plain = AdvisorSession(workload, opt).recommend(budget)
        sess = AdvisorSession(workload, opt)
        before = len(walks)
        plan = sess.peek_estimation_plan()
        assert sess.peek_estimation_plan() is plan
        jobs = sess.peek_cost_jobs()
        assert len(jobs) == len(workload.queries())   # all stale
        base = base_configuration(workload.schema)
        res = {q.name: sess.engine.candidate_query_costs(q, base, cands)
               for q, cands in jobs}
        assert sess.accept_cost_results(sess.workload_version, res) == \
            len(res)
        rec = sess.recommend(budget)
        assert rec.estimation_plan is plan
        assert_identical(rec, plain)
        assert sess.cost_prefetch_consumed == len(res)
        assert len(walks) - before == (backend == "torch")

    def test_stale_cost_results_dropped(self, schema, workload, drift_pool,
                                        base_size, backend):
        budget = 0.3 * base_size
        opt = dtac(backend)
        sess = AdvisorSession(workload, opt)
        ver = sess.workload_version
        sess.peek_cost_jobs()
        sess.add_statements([drift_pool[50]])
        assert sess.accept_cost_results(ver, {"q": np.zeros(3)}) == 0
        rec = sess.recommend(budget)
        fresh = DesignAdvisor(sess.workload, opt).recommend(budget)
        assert_identical(rec, fresh)
        assert sess.cost_prefetch_consumed == 0


# ---------------------------------------------------------------------------
# staged_recommend options threading (Example 1 baseline)
# ---------------------------------------------------------------------------

class TestStagedOptions:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_staged_honors_custom_e_q(self, workload, base_size, backend):
        opt = options(backend, e=1.0, q=0.8)
        rec = staged_recommend(workload, 0.3 * base_size, options=opt)
        assert rec.cost <= rec.base_cost + 1e-9


# ---------------------------------------------------------------------------
# Randomized delta sequences (hypothesis property), guarded with a soft
# import so the deterministic suite above always runs
# ---------------------------------------------------------------------------

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
@settings(max_examples=8, deadline=None)
@given(st.data())
def test_property_random_delta_sequences(backend, data):
    """Randomized add/remove/reweight sequences keep the session
    bit-identical to fresh advisors, and the replay counters keep showing
    cached work."""
    schema = make_tpch_like(scale=0.1, z=0, seed=0)
    wl = make_scaled_workload(schema, n_statements=14, seed=1)
    pool = [dataclasses.replace(s, name=f"p{i:02d}") for i, s in
            enumerate(make_scaled_workload(schema, n_statements=20,
                                           seed=6).statements)]
    base_size = sum(DesignAdvisor(wl, options("numpy")).sizes.size(i)
                    for i in base_configuration(schema).indexes)
    budget = 0.3 * base_size
    opt = dtac(backend)
    sess = AdvisorSession(wl, opt)
    assert_identical(sess.recommend(budget),
                     DesignAdvisor(wl, opt).recommend(budget))
    pool_at = 0
    for _ in range(data.draw(st.integers(1, 3), label="rounds")):
        names = [s.name for s in wl.statements]
        n_add = data.draw(st.integers(0, 2), label="n_add")
        n_rm = data.draw(st.integers(0, min(2, len(names) - 4)),
                         label="n_rm")
        rm = data.draw(st.permutations(names), label="rm")[:n_rm]
        added = tuple(pool[pool_at:pool_at + n_add])
        pool_at += n_add
        rw_names = [n for n in names if n not in set(rm)]
        n_rw = data.draw(st.integers(0, 3), label="n_rw")
        rw = tuple(
            (n, data.draw(st.floats(0.1, 5.0, allow_nan=False),
                          label="w"))
            for n in data.draw(st.permutations(rw_names),
                               label="rw")[:n_rw])
        delta = WorkloadDelta(added=added, removed=tuple(rm),
                              reweighted=rw)
        wl = wl.apply_delta(delta)
        sess.apply(delta)
        assert_identical(sess.recommend(budget),
                         DesignAdvisor(wl, opt).recommend(budget))
    stats = sess.stats
    if backend == "numpy":
        assert stats["replay_hits"] + stats["replay_verified"] > 0
    else:
        assert stats["replay_misses"] > 0
