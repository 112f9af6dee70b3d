"""The port's distinct-value estimators (`repro_torch.core.distinct`)
against the JAX package's: the frequency statistics, the Adaptive
Estimator and Table 1's multiply and optimizer baselines, `==` on the
same inputs (both are host NumPy), and the reference tests' properties."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core as rc
from repro.core import distinct as ref_dv
import repro_torch.core as pt
from repro_torch.core import distinct as dv
from torch_port_util import port_schema


def keys_of(seed, n, ndv, z):
    """Group keys: uniform (z = 0) or skewed (a Zipf-like head)."""
    rng = np.random.default_rng(seed)
    if z == 0:
        return rng.integers(0, ndv, n)
    return np.minimum(rng.zipf(1.0 + z, n) - 1, ndv - 1)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n,ndv,z", [(1, 1, 0), (50, 3, 0), (500, 400, 0),
                                     (2000, 60, 0.5), (4000, 5000, 1.0)])
def test_frequency_stats_and_estimates_equal_reference(seed, n, ndv, z):
    keys = keys_of(seed, n, ndv, z)
    freq = dv.frequency_stats(keys)
    assert freq == ref_dv.frequency_stats(keys)
    d = int(np.unique(keys).size)
    for n_rows in (n, 3 * n + 1, 40 * n):
        assert dv.adaptive_estimator(freq, d, n, n_rows) == \
            ref_dv.adaptive_estimator(freq, d, n, n_rows)
        for method in ("AE", "multiply"):
            assert dv.estimate_group_count(keys, n_rows, method) == \
                ref_dv.estimate_group_count(keys, n_rows, method)
    assert dv.ae_ndv(keys, 10 * n) == ref_dv.ae_ndv(keys, 10 * n)


@pytest.mark.parametrize("d,f", [(0, 0.05), (7, 0.05), (123, 0.01),
                                 (5, 1.0), (9, 0.0), (9, 1e-15)])
def test_multiply_equals_reference(d, f):
    assert dv.estimate_multiply(d, f) == ref_dv.estimate_multiply(d, f)


@pytest.mark.parametrize("ndvs,n", [((), 10), ((3,), 10), ((3, 7), 10),
                                    ((2500, 3, 7), 6_000_000),
                                    ((10 ** 6, 10 ** 6), 100)])
def test_optimizer_equals_reference(ndvs, n):
    assert dv.estimate_optimizer(ndvs, n) == \
        ref_dv.estimate_optimizer(ndvs, n)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        dv.estimate_group_count(np.arange(4), 10, "optimizer")


def test_ae_exact_when_full_sample():
    keys = np.array([1, 1, 2, 3, 3, 3])
    est = dv.adaptive_estimator(dv.frequency_stats(keys), 3, 6, 6)
    assert est == 3.0


@given(st.integers(10, 500), st.integers(2, 50), st.integers(0, 5))
@settings(max_examples=25, deadline=None)
def test_property_ae_bounded_by_n(n, ndv, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, ndv, n)
    est = dv.adaptive_estimator(
        dv.frequency_stats(keys), int(np.unique(keys).size), n, n * 10)
    assert 0 <= est <= n * 10
    assert est == ref_dv.adaptive_estimator(
        ref_dv.frequency_stats(keys), int(np.unique(keys).size), n, n * 10)


def test_table1_ordering():
    """AE error << multiply error on an aggregation MV (Table 1), on the
    reference test's schema."""
    schema = port_schema(rc.make_tpch_like(scale=0.3, z=0, seed=0))
    samples = pt.SampleManager(schema.tables, seed=0)
    syn = pt.SynopsisManager(schema, samples)
    mv = pt.MVDef("mv_ship", "lineitem", group_by=("l_shipdate",))
    _, n_ae = syn.mv_sample(mv, 0.05)
    li = schema.tables["lineitem"]
    true = li.ndv(["l_shipdate"])
    sample = samples.get_sample("lineitem", 0.05)
    d_sample = int(np.unique(sample.values["l_shipdate"]).size)
    n_mult = dv.estimate_multiply(d_sample, 0.05)
    err_ae = abs(n_ae / true - 1)
    err_mult = abs(n_mult / true - 1)
    assert err_ae < err_mult
    assert err_ae < 0.5
