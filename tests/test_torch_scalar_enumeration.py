"""The port's statement-at-a-time costing and enumeration against the JAX
package's: `candidates.cost_candidates` without an engine,
`enumeration.greedy_enumerate_scalar`, `DesignAdvisor` and
`staged_recommend` with `AdvisorOptions(use_engine=False)`.

Across the packages the scalar paths are float64 in one order on the same
inputs, so configurations, greedy steps and costs are equal bit for bit.
Inside the port the batched engines are held to the scalar paths as the
reference holds its own (twins of `tests/test_cost_engine.py`'s
`TestConfigCostParity.test_cost_candidates_engine_matches_scalar`,
`TestEnumerationParity` and `test_session.py`'s staged test): the numpy
engine within rel 1e-6 (it sums the same terms in another order), the
torch engine on the CPU (float32 scorers) within the same bound, an
equal-cost tie allowed where its float32 greedy ping-pongs between tied
clustered layouts (ROADMAP.md Queue C)."""
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import candidates as ref_cand
from repro.core.advisor import staged_recommend as ref_staged
from repro.core.enumeration import \
    greedy_enumerate_scalar as ref_greedy_scalar
import repro_torch.core as pt
from repro_torch.core import candidates as cand
from repro_torch.core.enumeration import (greedy_enumerate,
                                          greedy_enumerate_scalar)
from torch_port_util import labels, port_schema, port_workload

NUMPY = dict(backend="numpy")
TORCH_CPU = dict(device="cpu")


def _rel_err(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture(scope="module")
def ref_schema():
    return rc.make_tpch_like(scale=0.3, z=0, seed=0)


@pytest.fixture(scope="module")
def schema(ref_schema):
    return port_schema(ref_schema)


@pytest.fixture(scope="module")
def ref_workload(ref_schema):
    return rc.make_tpch_workload(ref_schema, insert_weight=0.1)


@pytest.fixture(scope="module")
def workload(ref_workload, schema):
    return port_workload(ref_workload, schema)


@pytest.fixture(scope="module")
def base_size(schema, workload):
    adv = pt.DesignAdvisor(workload, pt.AdvisorOptions(**NUMPY))
    return sum(adv.sizes.size(i)
               for i in pt.base_configuration(schema).indexes)


def assert_same_recs(got, want):
    """Two scalar-path recommendations of either package: the same
    configuration, greedy steps, costs and counts, bit for bit."""
    assert labels(got.config) == labels(want.config)
    assert got.steps == want.steps
    assert (got.cost, got.base_cost, got.used_bytes) == \
        (want.cost, want.base_cost, want.used_bytes)
    assert (got.n_sampled, got.n_deduced, got.candidate_count,
            got.pool_size) == (want.n_sampled, want.n_deduced,
                               want.candidate_count, want.pool_size)


def assert_close_or_tie(got, want, price):
    """A batched recommendation against the scalar one: cost within rel
    1e-6 and the same configuration, or an equal-cost tie that `price`
    (the scalar optimizer) puts at the scalar optimum's cost."""
    assert _rel_err(got.cost, want.cost) < 1e-6
    if labels(got.config) != labels(want.config):
        assert _rel_err(price(got.config), price(want.config)) < 1e-9


def test_cost_candidates_engine_matches_scalar(workload, schema,
                                               ref_workload, ref_schema):
    """Twin of test_cost_candidates_engine_matches_scalar on both engines;
    the port's scalar costs == the reference's, bit for bit."""
    base = pt.base_configuration(schema)
    ref_base = rc.base_configuration(ref_schema)
    adv = pt.DesignAdvisor(workload, pt.AdvisorOptions(**NUMPY))
    ref_adv = rc.DesignAdvisor(ref_workload)
    engines = [pt.CostEngine(workload, adv.sizes),
               pt.CostEngine(workload, adv.sizes, device=torch.device("cpu"))]
    for q, rq in zip(workload.queries()[:6], ref_workload.queries()[:6]):
        raw = cand.expand_with_compression(
            cand.syntactically_relevant(q, schema.tables[q.table]),
            ("NS", "LDICT"))
        rraw = ref_cand.expand_with_compression(
            ref_cand.syntactically_relevant(rq, ref_schema.tables[rq.table]),
            ("NS", "LDICT"))
        want = cand.cost_candidates(q, raw, base, adv.sizes,
                                    optimizer=adv.optimizer)
        ref = ref_cand.cost_candidates(rq, rraw, ref_base, ref_adv.optimizer,
                                       ref_adv.sizes)
        assert [c.index.label() for c in want] == \
            [c.index.label() for c in ref]
        assert [(c.cost, c.size) for c in want] == \
            [(c.cost, c.size) for c in ref]
        for engine, rtol in zip(engines, (1e-12, 1e-6)):
            got = cand.cost_candidates(q, raw, base, adv.sizes, engine)
            assert [c.index.key for c in got] == [c.index.key for c in want]
            np.testing.assert_allclose([c.cost for c in got],
                                       [c.cost for c in want], rtol=rtol)
            assert [c.size for c in got] == [c.size for c in want]
    with pytest.raises(ValueError):
        cand.cost_candidates(q, raw, base, adv.sizes)


@pytest.fixture(scope="module")
def pools(workload, schema, ref_workload, ref_schema):
    """Twin of TestEnumerationParity's set-up in both packages: sizes from
    estimate_sizes, the skyline pool from the scalar candidate costs."""
    out = {}
    adv = pt.DesignAdvisor(workload, pt.AdvisorOptions(use_engine=False,
                                                       **NUMPY))
    pq, merged_all, all_cands = adv._candidate_universe()
    adv.estimate_sizes(all_cands)
    base = pt.base_configuration(schema)
    pool = {}
    for q in workload.queries():
        for c in cand.select_skyline(cand.cost_candidates(
                q, pq[q.name], base, adv.sizes, optimizer=adv.optimizer)):
            pool.setdefault(c.index.key, c.index)
    for idx in merged_all:
        pool.setdefault(idx.key, idx)
    out["port"] = (adv, base, list(pool.values()))
    ref_adv = rc.DesignAdvisor(ref_workload, rc.AdvisorOptions(
        use_engine=False))
    pq, merged_all, all_cands = ref_adv._candidate_universe()
    ref_adv.estimate_sizes(all_cands)
    ref_base = rc.base_configuration(ref_schema)
    pool = {}
    for q in ref_workload.queries():
        for c in ref_cand.select_skyline(ref_cand.cost_candidates(
                q, pq[q.name], ref_base, ref_adv.optimizer, ref_adv.sizes)):
            pool.setdefault(c.index.key, c.index)
    for idx in merged_all:
        pool.setdefault(idx.key, idx)
    out["ref"] = (ref_adv, ref_base, list(pool.values()))
    return out


@pytest.mark.parametrize("variant", ["pure", "density", "backtrack"])
@pytest.mark.parametrize("frac", [0.0, 0.15, 0.4, 1.0])
def test_greedy_matches_scalar(pools, base_size, variant, frac):
    """Twin of test_greedy_matches_scalar: the port's scalar greedy ==
    the reference's (configuration, steps, cost and used bytes bit-equal);
    the numpy and the torch-CPU engines' greedy against it within rel
    1e-6, the same configuration on numpy."""
    adv, base, pool = pools["port"]
    ref_adv, ref_base, ref_pool = pools["ref"]
    assert [i.label() for i in pool] == [i.label() for i in ref_pool]
    budget = frac * base_size
    res_s = greedy_enumerate_scalar(adv.optimizer, adv.sizes, pool, base,
                                    budget, variant=variant)
    ref = ref_greedy_scalar(ref_adv.optimizer, ref_adv.sizes, ref_pool,
                            ref_base, budget, variant=variant)
    assert labels(res_s.config) == labels(ref.config)
    assert res_s.steps == ref.steps
    assert (res_s.cost, res_s.used_bytes) == (ref.cost, ref.used_bytes)
    for device in (None, torch.device("cpu")):
        engine = pt.CostEngine(adv.workload, adv.sizes, device=device)
        res_b = greedy_enumerate(engine, adv.sizes, pool, base, budget,
                                 variant=variant)
        assert _rel_err(res_b.cost, res_s.cost) < 1e-6
        assert _rel_err(res_b.used_bytes or 1.0,
                        res_s.used_bytes or 1.0) < 1e-6
        if device is None:
            assert res_b.config == res_s.config
        elif labels(res_b.config) != labels(res_s.config):
            assert _rel_err(adv.optimizer.workload_cost(res_b.config),
                            res_s.cost) < 1e-9


@pytest.mark.parametrize("frac", [0.0, 0.2, 0.6])
def test_recommend_matches_scalar_end_to_end(workload, ref_workload,
                                             base_size, frac):
    """Twin of test_recommend_matches_scalar_end_to_end: `recommend` with
    `use_engine=False` == the reference's (bit-equal) on numpy, and on
    torch-CPU too (the plan and SampleCF on the CPU give the same integer
    sizes, and the enumeration is the same float64 host code); the
    batched numpy and torch-CPU recommendations against it."""
    budget = frac * base_size
    rec_s = pt.DesignAdvisor(workload, pt.AdvisorOptions(
        use_engine=False, **NUMPY)).recommend(budget)
    ref = rc.DesignAdvisor(ref_workload, rc.AdvisorOptions(
        use_engine=False)).recommend(budget)
    assert_same_recs(rec_s, ref)
    adv_c = pt.DesignAdvisor(workload, pt.AdvisorOptions(
        use_engine=False, **TORCH_CPU))
    assert adv_c.build_engine() is None
    assert_same_recs(adv_c.recommend(budget), rec_s)
    for opts in (NUMPY, TORCH_CPU):
        rec_b = pt.DesignAdvisor(workload, pt.AdvisorOptions(
            **opts)).recommend(budget)
        assert_close_or_tie(rec_b, rec_s, adv_c.optimizer.workload_cost)
        assert _rel_err(rec_b.base_cost, rec_s.base_cost) < 1e-6


@pytest.mark.parametrize("which", ["scaled_seed5", "insert_heavy"])
def test_recommend_scalar_other_workloads(ref_schema, schema, base_size,
                                          which):
    """Twins of test_recommend_matches_scalar_scaled_workload (its seed 5:
    no equal-cost optima) and test_insert_heavy_parity: the port's
    scalar recommend == the reference's; the numpy engine's the same
    configuration within rel 1e-6."""
    if which == "scaled_seed5":
        ref_wl = rc.make_scaled_workload(ref_schema, n_statements=60,
                                         seed=5)
        budget = 0.25 * base_size
    else:
        ref_wl = rc.make_tpch_workload(ref_schema, insert_weight=50.0)
        budget = 0.5 * base_size
    wl = port_workload(ref_wl, schema)
    rec_s = pt.DesignAdvisor(wl, pt.AdvisorOptions(
        use_engine=False, **NUMPY)).recommend(budget)
    assert_same_recs(rec_s, rc.DesignAdvisor(ref_wl, rc.AdvisorOptions(
        use_engine=False)).recommend(budget))
    rec_b = pt.DesignAdvisor(wl, pt.AdvisorOptions(**NUMPY)).recommend(
        budget)
    assert rec_b.config == rec_s.config
    assert _rel_err(rec_b.cost, rec_s.cost) < 1e-6


@pytest.mark.parametrize("opts", [NUMPY, TORCH_CPU],
                         ids=["numpy", "torch-cpu"])
def test_staged_scalar_engine(workload, ref_workload, base_size, opts):
    """Twin of test_staged_scalar_engine_close_to_batched: the staged
    baseline with `use_engine=False` == the reference's (configuration,
    cost, used bytes bit-equal), the batched one within rel 1e-6; all
    three switches off the same."""
    b = 0.3 * base_size
    rec_s = pt.staged_recommend(workload, b, options=pt.AdvisorOptions(
        use_engine=False, **opts))
    ref = ref_staged(ref_workload, b, options=rc.AdvisorOptions(
        use_engine=False))
    assert labels(rec_s.config) == labels(ref.config)
    assert (rec_s.cost, rec_s.used_bytes) == (ref.cost, ref.used_bytes)
    rec_b = pt.staged_recommend(workload, b,
                                options=pt.AdvisorOptions(**opts))
    assert labels(rec_b.config) == labels(rec_s.config)
    assert abs(rec_b.cost - rec_s.cost) <= 1e-6 * max(rec_s.cost, 1.0)
    off = dict(use_engine=False, use_batched_estimation=False,
               use_batched_planner=False)
    rec_o = pt.staged_recommend(workload, b, options=pt.AdvisorOptions(
        **off, **opts))
    ref_o = ref_staged(ref_workload, b, options=rc.AdvisorOptions(**off))
    assert labels(rec_o.config) == labels(ref_o.config)
    assert (rec_o.cost, rec_o.used_bytes) == (ref_o.cost, ref_o.used_bytes)
