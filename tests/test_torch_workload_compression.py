"""The port's large-workload entry points against the JAX package: the
scaled workload generator, workload compression with its error
certificate, the scalar statement costs the certificate prices with, the
advisor over all five codecs with and without `compression_budget`, and
`staged_recommend` (Example 1).

* numpy backend: `==` the reference's numpy backend (workloads, clusters,
  certificates, recommendations).
* torch backend on the CPU (the kernels' plain versions): against the
  reference's `backend="jax"` (Pallas interpret mode, run once per module
  and case): the same plan and representatives, the same greedy steps up
  to the float32 tie ping-pong (ROADMAP.md Queue C), cost and used bytes
  within rtol 1e-6 (float32 scoring), the configuration equal or an
  equal-cost tie judged by the port's numpy pipeline.

Sizes stay small: `make_tpch_like(scale=1)` and at most 2,000 statements.
"""
import dataclasses
import math

import pytest

from repro.core import workload as ref_wl
from repro.core import whatif as ref_whatif
from repro.core import workload_compression as ref_wc
from repro.core.advisor import AdvisorOptions as RefOptions
from repro.core.advisor import DesignAdvisor as RefAdvisor
from repro.core.advisor import staged_recommend as ref_staged
import repro_torch.core as pt
from repro_torch.core import whatif, workload_compression as wc
from torch_port_util import (assert_same_steps_up_to_ping_pong, labels,
                             port_config, port_schema, port_workload,
                             statement_spec)

FIVE = ("NS", "GDICT", "LDICT", "PREFIX", "RLE")
N_SCALED = 2000


@pytest.fixture(scope="module")
def ref_schema():
    return ref_wl.make_tpch_like(scale=1.0, z=0.0, seed=0)


@pytest.fixture(scope="module")
def schema(ref_schema):
    return port_schema(ref_schema)


@pytest.fixture(scope="module")
def budget(ref_schema):
    return 0.25 * sum(t.nrows * (sum(c.width for c in t.columns) + 4)
                      for t in ref_schema.tables.values())


@pytest.fixture(scope="module")
def ref_scaled(ref_schema):
    return ref_wl.make_scaled_workload(ref_schema, n_statements=N_SCALED,
                                       insert_fraction=0.1, seed=0)


@pytest.fixture(scope="module")
def scaled(schema):
    return pt.make_scaled_workload(schema, n_statements=N_SCALED,
                                   insert_fraction=0.1, seed=0)


@pytest.fixture(scope="module")
def ref_tpch(ref_schema):
    return ref_wl.make_tpch_workload(ref_schema, insert_weight=0.1)


@pytest.fixture(scope="module")
def tpch(ref_tpch, schema):
    return port_workload(ref_tpch, schema)


def same_plan(a, b) -> bool:
    return ((a.estimation_plan.f, a.n_sampled, a.n_deduced,
             a.estimation_cost_pages) ==
            (b.estimation_plan.f, b.n_sampled, b.n_deduced,
             b.estimation_cost_pages))


def assert_equal_recommendations(got, want):
    assert labels(got.config) == labels(want.config)
    assert (got.cost, got.used_bytes, got.base_cost, got.steps) == \
        (want.cost, want.used_bytes, want.base_cost, want.steps)
    assert (got.candidate_count, got.pool_size) == \
        (want.candidate_count, want.pool_size)
    assert same_plan(got, want)
    assert (got.n_statements_full, got.n_representatives,
            got.compression_error_bound, got.compression_error_rel) == \
        (want.n_statements_full, want.n_representatives,
         want.compression_error_bound, want.compression_error_rel)


def assert_close_or_tie(got, want_jax, numpy_adv):
    """`got` (torch CPU) against the reference's jax run; a different
    configuration passes only as an equal-cost tie: the port's numpy
    pipeline (== the reference's numpy, tested here too) prices both
    configurations at the same cost within rtol 1e-6."""
    assert same_plan(got, want_jax)
    assert got.n_representatives == want_jax.n_representatives
    assert_same_steps_up_to_ping_pong(got.steps, want_jax.steps)
    assert math.isclose(got.cost, want_jax.cost, rel_tol=1e-6)
    assert math.isclose(got.used_bytes, want_jax.used_bytes, rel_tol=1e-6)
    if labels(got.config) == labels(want_jax.config):
        assert math.isclose(got.compression_error_bound,
                            want_jax.compression_error_bound, rel_tol=1e-6)
        return
    judge = (numpy_adv.inner or numpy_adv).build_engine().config_cost
    assert math.isclose(judge(got.config),
                        judge(port_config(want_jax.config)), rel_tol=1e-6)


# ---------------------------------------------------------------------------
# make_scaled_workload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,insert_fraction", [
    (0, N_SCALED, 0.1), (7, 500, 0.3), (3, 1, 0.0)])
def test_scaled_workload_equals_reference(ref_schema, schema, seed, n,
                                          insert_fraction):
    want = ref_wl.make_scaled_workload(ref_schema, n_statements=n,
                                       insert_fraction=insert_fraction,
                                       seed=seed)
    got = pt.make_scaled_workload(schema, n_statements=n,
                                  insert_fraction=insert_fraction, seed=seed)
    assert [statement_spec(s) for s in got.statements] == \
        [statement_spec(s) for s in want.statements]
    assert got.schema is schema


# ---------------------------------------------------------------------------
# scalar statement costs
# ---------------------------------------------------------------------------

def _sizes_pair(ref_schema, schema, ref_cfg):
    """Reference and port SizeProviders with equal registered sizes for
    every compressed index of `ref_cfg`."""
    ref_sizes = ref_whatif.SizeProvider(ref_schema)
    sizes = whatif.SizeProvider(schema)
    for k, i in enumerate(sorted(ref_cfg.indexes, key=lambda i: i.label())):
        if i.compression is not None:
            b = 0.3 * ref_sizes.analytic_uncompressed(i) + 17.0 * k
            ref_sizes.register(i, b)
            sizes.register(pt.IndexDef(i.table, tuple(i.cols),
                                       i.compression, i.clustered), b)
    return ref_sizes, sizes


def _configs(ref_schema):
    """Predicate-free configurations: the base, compressed clustered
    layouts, and secondary indexes that cover, seek and miss."""
    from repro.core.relation import IndexDef
    base = ref_whatif.base_configuration(ref_schema)
    li = base.clustered("lineitem")
    od = base.clustered("orders")
    comp = base.replace(li, li.with_compression("RLE")) \
        .replace(od, od.with_compression("PREFIX"))
    sec = comp.add(IndexDef("lineitem", ("l_shipdate", "l_discount",
                                         "l_extendedprice"), "LDICT")) \
        .add(IndexDef("lineitem", ("l_partkey",), None)) \
        .add(IndexDef("orders", ("o_orderdate", "o_custkey"), "NS")) \
        .add(IndexDef("part", ("p_brand", "p_size", "p_partkey"), "GDICT"))
    return [base, comp, sec]


def test_statement_costs_equal_reference(ref_schema, schema, ref_scaled,
                                         scaled):
    for ref_cfg in _configs(ref_schema):
        ref_sizes, sizes = _sizes_pair(ref_schema, schema, ref_cfg)
        cfg = port_config(ref_cfg)
        for rs, s in zip(ref_scaled.statements[::7],
                         scaled.statements[::7]):
            if hasattr(rs, "filters"):
                want = ref_whatif.query_cost(rs, ref_cfg, ref_sizes)
                got = whatif.query_cost(s, cfg, sizes)
            else:
                want = ref_whatif.update_statement_cost(rs, ref_cfg,
                                                        ref_sizes)
                got = whatif.update_statement_cost(s, cfg, sizes)
            assert got == want, s.name
        assert [i.label() for i in cfg.for_table("lineitem")] == \
            [i.label() for i in ref_cfg.for_table("lineitem")]


# ---------------------------------------------------------------------------
# compress_workload
# ---------------------------------------------------------------------------

def cluster_view(comp) -> list:
    return [(c.tier, c.sig, statement_spec(c.rep), sorted(c.members),
             c.weight, c.certified) for c in comp.clusters]


@pytest.mark.parametrize("budget_n", [None, 32, 128, N_SCALED,
                                      N_SCALED + 1])
def test_compress_workload_equals_reference(ref_schema, schema, ref_scaled,
                                            scaled, budget_n):
    want = ref_wc.compress_workload(ref_scaled, budget_n)
    got = wc.compress_workload(scaled, budget_n)
    if budget_n is None or budget_n >= N_SCALED:
        assert got is None and want is None
        return
    assert (got.n_full, got.budget, got.n_representatives) == \
        (want.n_full, want.budget, want.n_representatives)
    assert got.n_representatives <= budget_n
    assert [statement_spec(s) for s in got.workload.statements] == \
        [statement_spec(s) for s in want.workload.statements]
    assert cluster_view(got) == cluster_view(want)
    assert got.cluster_of() == want.cluster_of()
    assert got.compression_ratio == want.compression_ratio
    for ref_cfg in _configs(ref_schema):
        ref_sizes, sizes = _sizes_pair(ref_schema, schema, ref_cfg)
        assert got.error_bound(port_config(ref_cfg), sizes) == \
            want.error_bound(ref_cfg, ref_sizes)


def test_cluster_index_maintenance_matches_fresh(scaled):
    """add / remove / reweight derive the same compressed workload as a
    fresh index on the resulting statements."""
    ix = wc.ClusterIndex.from_workload(scaled)
    stmts = list(scaled.statements)
    for s in stmts[:40]:
        ix.remove(s.name)
    for s in stmts[40:60]:
        ix.reweight(s.name, 3.5)
    rest = [dataclasses.replace(s, weight=3.5) if k < 60 else s
            for k, s in enumerate(stmts) if k >= 40]
    fresh = wc.ClusterIndex.from_workload(pt.Workload(scaled.schema, rest))
    assert len(ix) == len(fresh) == len(rest)
    assert cluster_view(ix.derive(64)) == cluster_view(fresh.derive(64))
    with pytest.raises(ValueError, match="duplicate"):
        ix.add(rest[0])


# ---------------------------------------------------------------------------
# DesignAdvisor.recommend over the five codecs, with and without
# workload compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget_n", [32, 128])
def test_numpy_compressed_recommend_equals_reference(ref_scaled, scaled,
                                                     budget, budget_n):
    want = RefAdvisor(ref_scaled, RefOptions(
        backend="numpy", methods=FIVE,
        compression_budget=budget_n)).recommend(budget)
    adv = pt.DesignAdvisor(scaled, pt.AdvisorOptions(
        backend="numpy", methods=FIVE, compression_budget=budget_n))
    got = adv.recommend(budget)
    assert_equal_recommendations(got, want)
    assert got.n_statements_full == N_SCALED
    assert got.n_representatives <= budget_n
    assert got.compression_error_bound > 0.0
    assert adv.inner is not None and adv.inner.samples is adv.samples
    assert len(adv.compressed.clusters) == got.n_representatives
    assert set(got.phase_seconds) == set(pt.advisor.PHASES)
    assert got.phase_seconds["compression"] > 0.0


@pytest.fixture(scope="module")
def scaled_128_jax_and_numpy(ref_scaled, scaled, budget):
    want = RefAdvisor(ref_scaled, RefOptions(
        backend="jax", methods=FIVE, compression_budget=128)) \
        .recommend(budget)
    adv_n = pt.DesignAdvisor(scaled, pt.AdvisorOptions(
        backend="numpy", methods=FIVE, compression_budget=128))
    adv_n.recommend(budget)
    return want, adv_n


def test_torch_cpu_compressed_recommend_close_to_reference_jax(
        scaled, budget, scaled_128_jax_and_numpy):
    want, adv_n = scaled_128_jax_and_numpy
    got = pt.DesignAdvisor(scaled, pt.AdvisorOptions(
        backend="torch", device="cpu", methods=FIVE,
        compression_budget=128)).recommend(budget)
    assert_close_or_tie(got, want, adv_n)
    assert any(i.compression in ("PREFIX", "RLE")
               for i in got.config.indexes)


@pytest.mark.parametrize("budget_n", [None, 8])
def test_torch_cpu_five_codecs_close_to_reference_jax(ref_tpch, tpch, budget,
                                                      budget_n):
    want = RefAdvisor(ref_tpch, RefOptions(
        backend="jax", methods=FIVE,
        compression_budget=budget_n)).recommend(budget)
    adv_n = pt.DesignAdvisor(tpch, pt.AdvisorOptions(
        backend="numpy", methods=FIVE, compression_budget=budget_n))
    adv_n.recommend(budget)
    got = pt.DesignAdvisor(tpch, pt.AdvisorOptions(
        backend="torch", device="cpu", methods=FIVE,
        compression_budget=budget_n)).recommend(budget)
    assert_close_or_tie(got, want, adv_n)
    assert got.n_representatives == (8 if budget_n else len(tpch.statements))


# ---------------------------------------------------------------------------
# staged_recommend (Example 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget_frac", [0.0, 0.25, 1.0])
@pytest.mark.parametrize("methods", [FIVE, ("NS", "LDICT")])
def test_numpy_staged_equals_reference(ref_tpch, tpch, budget, budget_frac,
                                       methods):
    b = budget * budget_frac / 0.25
    want = ref_staged(ref_tpch, b, methods=methods,
                      options=RefOptions(backend="numpy"))
    got = pt.staged_recommend(tpch, b, methods=methods,
                              options=pt.AdvisorOptions(backend="numpy"))
    assert labels(got.config) == labels(want.config)
    assert (got.cost, got.used_bytes, got.base_cost, got.steps) == \
        (want.cost, want.used_bytes, want.base_cost, want.steps)


@pytest.mark.parametrize("budget_frac", [0.25, 1.0])
def test_torch_cpu_staged_close_to_reference(ref_tpch, tpch, budget,
                                             budget_frac):
    b = budget * budget_frac / 0.25
    want = ref_staged(ref_tpch, b, methods=FIVE,
                      options=RefOptions(backend="jax"))
    got = pt.staged_recommend(tpch, b, methods=FIVE,
                              options=pt.AdvisorOptions(backend="torch",
                                                        device="cpu"))
    assert labels(got.config) == labels(want.config)
    assert math.isclose(got.cost, want.cost, rel_tol=1e-6)
    assert math.isclose(got.used_bytes, want.used_bytes, rel_tol=1e-6)
    assert got.steps == want.steps
    # stage 2 compressed at least one chosen index
    assert any(i.compression is not None and not i.clustered
               for i in got.config.indexes)


def test_staged_default_methods_follow_options(tpch, budget):
    opts = pt.AdvisorOptions(backend="numpy", methods=("RLE",))
    got = pt.staged_recommend(tpch, budget, options=opts)
    assert {i.compression for i in got.config.indexes
            if not i.clustered} <= {None, "RLE"}
