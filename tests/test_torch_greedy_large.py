"""The port's float32 greedy, step for step the JAX package's, on a scaled
workload whose lineitem has more than 4,096 queries.

`make_scaled_workload(6200)` over `make_tpch_like(scale=1)` gives lineitem
4,214 queries (seed 0), past the 4,096 at which XLA's CPU code stops
fusing the scorers' dot (`cost_engine._gemv_order`).  A whole `recommend`
at this size is minutes on the CPU, so the step where the scorers are
called is held alone: both packages' cost engines are built from the same
statements and sizes, and `greedy_enumerate` runs over one candidate pool
(the compression-expanded candidates of the first 30 statements, twins
built from one label-sorted list).  The sizes are the uncompressed bytes
times the reference's CF prior, registered in both size providers.  The
reference runs on its jax engine, the port on torch/cpu: they take the
same steps and end on the same configuration and cost, bit for bit.  With
seeds 0 and 2 the greedy's order at 4,214 queries decides a near-tie at
step 7.
"""
import pytest
import torch

import repro_torch.core as pt
from repro.core import cost_engine as ref_ce
from repro.core import enumeration as ref_en
from repro.core import whatif as ref_wi
from repro.core import workload as ref_wl
from repro.core.advisor import AdvisorOptions as RefOptions
from repro.core.advisor import DesignAdvisor as RefAdvisor
from repro_torch.core import cost_engine as ce
from repro_torch.core import enumeration as en
from torch_config_twins import port_index
from torch_port_util import labels, port_workload

STATEMENTS = 6200
POOL_STATEMENTS = 30
# every compressed candidate at the reference's analytic CF prior
CF = ref_wi.SizeProvider.DEFAULT_CF_PRIOR


def _pool(ref_workload):
    per_query, _, _ = RefAdvisor(ref_workload,
                                 RefOptions())._candidate_universe()
    seen = {}
    for name in list(per_query)[:POOL_STATEMENTS]:
        for idx in per_query[name]:
            seen.setdefault(idx.key, idx)
    return sorted(seen.values(), key=lambda i: i.label())


@pytest.mark.parametrize("seed", [0, 2])
def test_torch_cpu_greedy_equals_reference_jax_past_4096_queries(seed):
    schema = ref_wl.make_tpch_like(scale=1.0, z=0.0, seed=0)
    ref = ref_wl.make_scaled_workload(schema, STATEMENTS, seed=seed)
    assert sum(q.table == "lineitem" for q in ref.queries()) > 4096
    pool = _pool(ref)
    twins = [port_index(i) for i in pool]
    work = port_workload(ref)
    ref_sizes, sizes = ref_wi.SizeProvider(schema), pt.SizeProvider(
        work.schema)
    for idx, twin in zip(pool, twins):
        if idx.compression is not None:
            b = ref_sizes.analytic_uncompressed(idx) * CF
            ref_sizes.register(idx, b)
            sizes.register(twin, b)
    budget = 0.25 * sum(t.nrows * (sum(c.width for c in t.columns) + 4)
                        for t in schema.tables.values())

    want = ref_en.greedy_enumerate(
        ref_wi.WhatIfOptimizer(ref, ref_sizes), ref_sizes, pool,
        ref_wi.base_configuration(schema), budget,
        engine=ref_ce.CostEngine(ref, ref_sizes, backend="jax"))
    got = en.greedy_enumerate(
        ce.CostEngine(work, sizes, device=torch.device("cpu")), sizes,
        twins, pt.base_configuration(work.schema), budget)
    assert got.steps == want.steps
    assert labels(got.config) == labels(want.config)
    assert (got.cost, got.used_bytes) == (want.cost, want.used_bytes)
