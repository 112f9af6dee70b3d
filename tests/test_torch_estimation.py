"""SampleCF estimation in the port against the JAX package.

Integer and float64 paths, so every comparison is exact: the port's
`make_tpch_like` arrays are `==` the reference's; its sort permutations
(NumPy, and the torch version computed on the device) are bit-identical to
the reference's `_prefix_permutations`, including the >63-bit lexsort
fallback; and its `EstimationEngine` gives bit-identical `est_bytes`, `cf`
and `cost_pages` on both backends (torch here on the CPU, through the
plain versions of the codec kernels).  The numpy planner's plan is
identical to the reference's numpy plan.
"""
import numpy as np
import pytest
import torch

from repro.core import workload as ref_wl
from repro.core.advisor import DesignAdvisor as RefAdvisor
from repro.core.estimation_engine import (
    EstimationEngine as RefEngine, _prefix_permutations as ref_perms)
from repro.core.estimation_graph import EstimationPlanner as RefPlanner
from repro.core.relation import ColumnDef as RefCol, Table as RefTable
from repro.core.samplecf import SampleManager as RefManager
from repro_torch.core import estimation_engine as ee
from repro_torch.core import workload as pw
from repro_torch.core.estimation_graph import EstimationPlanner, NodeKey
from repro_torch.core.relation import IndexDef
from repro_torch.core.samplecf import SampleManager, sample_cf
from torch_port_util import port_schema, tables_equal

F_VALUES = (0.01, 0.05, 0.1)


@pytest.fixture(scope="module")
def ref_schema():
    return ref_wl.make_tpch_like(scale=1.0, z=0.0, seed=0)


@pytest.fixture(scope="module")
def schema(ref_schema):
    return port_schema(ref_schema)


@pytest.fixture(scope="module")
def ref_targets(ref_schema):
    wl = ref_wl.make_tpch_workload(ref_schema, insert_weight=0.1)
    adv = RefAdvisor(wl)
    return list(adv.estimation_targets(adv.generate_candidates()))


def to_port_keys(ref_keys):
    return [NodeKey(k.table, k.cols, k.method) for k in ref_keys]


@pytest.mark.parametrize("scale,z,seed", [(1.0, 0.0, 0), (0.5, 1.0, 3)])
def test_make_tpch_like_equals_reference(scale, z, seed):
    assert tables_equal(ref_wl.make_tpch_like(scale=scale, z=z, seed=seed),
                        pw.make_tpch_like(scale=scale, z=z, seed=seed))


def test_samples_equal_reference(ref_schema, schema):
    ref_m = RefManager(ref_schema.tables, seed=4)
    m = SampleManager(schema.tables, seed=4)
    for f in F_VALUES:
        for name in schema.tables:
            a, b = ref_m.get_sample(name, f), m.get_sample(name, f)
            for c in a.columns:
                np.testing.assert_array_equal(a.values[c.name],
                                              b.values[c.name])


def _wide_table(n=10000, seed=0):
    """Five columns of ~2^13 distinct values each: their packed ranks
    need more than 63 bits, which forces the lexsort fallback."""
    rng = np.random.default_rng(seed)
    cols = {f"c{i}": rng.integers(0, 1 << 32, size=n) for i in range(5)}
    cols["small"] = rng.integers(0, 3, size=n)
    cols["mid"] = rng.integers(0, 50, size=n)
    return cols


@pytest.mark.parametrize("prefixes", [
    [("small",), ("small", "mid"), ("mid", "c0"), ("c1",)],
    [("c0", "c1", "c2", "c3", "c4"), ("c0", "c1"), ("small", "mid", "c2")],
])
def test_prefix_permutations_bit_identical(prefixes):
    vals = _wide_table()
    wide = ("c0", "c1", "c2", "c3", "c4")
    assert sum(int(np.unique(vals[c]).size - 1).bit_length()
               for c in wide) > 63
    table = RefTable("t", [RefCol(c, 8) for c in vals], vals)
    want = ref_perms(table, prefixes)
    got_np = ee._prefix_permutations(table, prefixes)
    got_t = ee.prefix_permutations_torch(
        {c: torch.as_tensor(v) for c, v in vals.items()}, prefixes)
    assert set(got_np) == set(want) == set(got_t)
    for p in want:
        np.testing.assert_array_equal(got_np[p], want[p])
        np.testing.assert_array_equal(got_t[p].numpy(), want[p])


def test_prefix_permutations_on_advisor_samples(ref_schema, schema,
                                                ref_targets):
    ref_m = RefManager(ref_schema.tables, seed=0)
    for name in ("lineitem", "orders"):
        prefixes = sorted({k.cols[:j + 1] for k in ref_targets
                           if k.table == name for j in range(len(k.cols))})
        sample = ref_m.get_sample(name, 0.05)
        want = ref_perms(sample, prefixes)
        got = ee.prefix_permutations_torch(
            {c.name: torch.as_tensor(sample.values[c.name])
             for c in sample.columns}, prefixes)
        for p in want:
            np.testing.assert_array_equal(got[p].numpy(), want[p])


@pytest.mark.parametrize("device", [None, torch.device("cpu")],
                         ids=["numpy", "torch-cpu"])
@pytest.mark.parametrize("f", F_VALUES)
def test_engine_estimates_bit_identical(ref_schema, schema, ref_targets,
                                        device, f):
    ref = RefEngine(ref_schema.tables, RefManager(ref_schema.tables, seed=0))
    eng = ee.EstimationEngine(schema.tables,
                              SampleManager(schema.tables, seed=0),
                              device=device)
    want = ref.estimate_batch(ref_targets, f)
    got = eng.estimate_batch(to_port_keys(ref_targets), f)
    assert len(got) == len(want) == len(ref_targets)
    for rk, pk in zip(ref_targets, to_port_keys(ref_targets)):
        a, b = want[rk], got[pk]
        assert (a.est_bytes, a.cf, a.cost_pages) == \
            (b.est_bytes, b.cf, b.cost_pages), rk.label()
    if device is not None:
        assert eng.stats()["device_samples"] == len(
            {k.table for k in ref_targets})


def test_engine_equals_scalar_sample_cf(schema, ref_targets):
    keys = to_port_keys(ref_targets)[::7]
    m = SampleManager(schema.tables, seed=1)
    got = ee.EstimationEngine(schema.tables, m,
                              device=torch.device("cpu")).estimate_batch(
                                  keys, 0.025)
    for k in keys:
        one = sample_cf(m, IndexDef(k.table, k.cols, k.method), 0.025)
        assert got[k].est_bytes == one.est_bytes
        assert got[k].cost_pages == one.cost_pages


@pytest.mark.parametrize("all_sampled", [False, True])
def test_numpy_plan_identical_to_reference(ref_schema, schema, ref_targets,
                                           all_sampled):
    ref = RefPlanner(ref_schema.tables, record=False)
    planner = EstimationPlanner(schema.tables)
    keys = to_port_keys(ref_targets)
    if all_sampled:
        a = ref.plan_all_sampled(ref_targets, 0.5, 0.9)
        b = planner.plan_all_sampled(keys, 0.5, 0.9)
    else:
        a = ref.plan(ref_targets, 0.5, 0.9)
        b = planner.plan(keys, 0.5, 0.9)
    assert (a.f, a.total_cost, a.feasible) == (b.f, b.total_cost, b.feasible)
    assert [k.label() for k in a.nodes] == [k.label() for k in b.nodes]
    for ka, kb in zip(a.nodes, b.nodes):
        na, nb = a.nodes[ka], b.nodes[kb]
        assert na.state.value == nb.state.value
        assert (na.rv.mean, na.rv.std) == (nb.rv.mean, nb.rv.std)
        if na.chosen is not None:
            assert [c.label() for c in na.chosen.children] == \
                [c.label() for c in nb.chosen.children]
