"""The port's float32 greedy on a scaled workload, step for step the JAX
package's.

On `make_tpch_like(scale=1)` with `make_scaled_workload(200)` at a budget
of 25 % of the base size, the reference's float32 jax backend takes 6
greedy steps with seed 1 and runs to its step limit, swapping one table's
clustered layout, with seed 0.  The step scores there come from the
replace and secondary scorers at 135 queries (lineitem), whose totals the
port sums in XLA's order (`cost_engine._xla_sum_order`); with another
order the port's steps differ from the first near-zero benefit on.  The
port's torch backend on the CPU takes exactly the reference's steps and
ends on its configuration, estimation plan and cost.
"""
import pytest

from repro.core import workload as ref_wl
from repro.core.advisor import AdvisorOptions as RefOptions
from repro.core.advisor import DesignAdvisor as RefAdvisor
from repro_torch.core import advisor as pa
from torch_port_util import labels, port_workload


@pytest.mark.parametrize("seed", [1, 0])
def test_torch_cpu_steps_equal_reference_jax_on_scaled_workload(seed):
    schema = ref_wl.make_tpch_like(scale=1.0, z=0.0, seed=0)
    ref = ref_wl.make_scaled_workload(schema, 200, seed=seed)
    budget = 0.25 * sum(t.nrows * (sum(c.width for c in t.columns) + 4)
                        for t in schema.tables.values())
    want = RefAdvisor(ref, RefOptions(backend="jax")).recommend(budget)
    got = pa.DesignAdvisor(port_workload(ref), pa.AdvisorOptions(
        backend="torch", device="cpu")).recommend(budget)
    assert got.steps == want.steps
    assert labels(got.config) == labels(want.config)
    plan = (want.estimation_plan.f, want.n_sampled, want.n_deduced,
            want.estimation_cost_pages)
    assert (got.estimation_plan.f, got.n_sampled, got.n_deduced,
            got.estimation_cost_pages) == plan
    assert (got.cost, got.used_bytes) == (want.cost, want.used_bytes)
