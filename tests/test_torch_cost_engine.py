"""The port's batched what-if cost engine against the JAX package.

Both engines cost the same workload under the same estimated sizes (each
package's own `estimate_sizes`, whose results are bit-identical, see
test_torch_estimation.py).  numpy backend: every cost is bitwise equal to
the reference's numpy backend.  torch backend (on the CPU): the float32
device scorers are held to the reference's float32 `jax.jit` scorers at
rtol 1e-5 (same op sequence; the weighted sums may add in another order).
"""
import numpy as np
import pytest
import torch

from repro.core import workload as ref_wl
from repro.core.advisor import AdvisorOptions as RefOptions
from repro.core.advisor import DesignAdvisor as RefAdvisor
from repro.core.cost_engine import CostEngine as RefEngine
from repro.core.enumeration import greedy_enumerate as ref_greedy
from repro.core.whatif import base_configuration as ref_base
from repro_torch.core import advisor as pa
from repro_torch.core.cost_engine import CostEngine
from repro_torch.core.enumeration import greedy_enumerate
from repro_torch.core.relation import IndexDef
from repro_torch.core.whatif import Configuration, base_configuration
from torch_port_util import labels, port_workload

CPU = torch.device("cpu")


def port_idx(ref_idx) -> IndexDef:
    assert ref_idx.predicate is None
    return IndexDef(ref_idx.table, ref_idx.cols, ref_idx.compression,
                    ref_idx.clustered)


@pytest.fixture(scope="module")
def env():
    """Reference and port advisors on one workload, sizes estimated."""
    schema = ref_wl.make_tpch_like(scale=1.0, z=0.0, seed=0)
    rwl = ref_wl.make_tpch_workload(schema, insert_weight=0.5)
    ref = RefAdvisor(rwl, RefOptions(backend="numpy"))
    port = pa.DesignAdvisor(port_workload(rwl),
                            pa.AdvisorOptions(backend="numpy"))
    r_per_q, r_merged, r_all = ref._candidate_universe()
    ref.estimate_sizes(r_all)
    p_per_q, _, p_all = port._candidate_universe()
    port.estimate_sizes(p_all)
    assert [i.label() for i in r_all] == [i.label() for i in p_all]
    return ref, port, r_per_q, p_per_q, r_all


def engines(env, torch_backend):
    ref, port, *_ = env
    r_eng = RefEngine(ref.workload, ref.sizes,
                      backend="jax" if torch_backend else "numpy")
    p_eng = CostEngine(port.workload, port.sizes,
                       device=CPU if torch_backend else None)
    return r_eng, p_eng


def check(got, want, torch_backend):
    if torch_backend:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("torch_backend", [False, True],
                         ids=["numpy", "torch-cpu"])
def test_candidate_query_costs(env, torch_backend):
    ref, port, r_per_q, p_per_q, _ = env
    r_eng, p_eng = engines(env, torch_backend)
    r_base, p_base = ref_base(ref.schema), base_configuration(port.schema)
    for rq, pq in zip(ref.workload.queries(), port.workload.queries()):
        want = r_eng.candidate_query_costs(rq, r_base, r_per_q[rq.name])
        got = p_eng.candidate_query_costs(pq, p_base, p_per_q[pq.name])
        check(got, want, torch_backend)


@pytest.mark.parametrize("torch_backend", [False, True],
                         ids=["numpy", "torch-cpu"])
def test_greedy_step_scores(env, torch_backend):
    """Add-secondary and replace-clustered scores for every candidate of
    every table, from the base and from a base with two secondaries."""
    ref, port, _, _, r_all = env
    r_eng, p_eng = engines(env, torch_backend)
    r_cfg, p_cfg = ref_base(ref.schema), base_configuration(port.schema)
    for table in ("lineitem", "orders"):
        cands = [i for i in r_all if i.table == table]
        secs = [i for i in cands if not i.clustered]
        cls = [i for i in cands if i.clustered]
        for extra in ((), tuple(secs[:2])):
            rc = r_cfg
            pc = p_cfg
            for i in extra:
                rc, pc = rc.add(i), pc.add(port_idx(i))
            r_cid, r_sec = r_eng.split(rc, table)
            p_cid, p_sec = p_eng.split(pc, table)
            assert (r_cid, r_sec) == (p_cid, p_sec)
            cur_q = r_eng.table_eval(rc, table).q_cost
            np.testing.assert_array_equal(
                cur_q, p_eng.table_eval(pc, table).q_cost)
            r_ids = r_eng.register(secs)
            p_ids = p_eng.register([port_idx(i) for i in secs])
            np.testing.assert_array_equal(r_ids, p_ids)
            for a, b in zip(r_eng.score_add_secondary(table, r_cid, cur_q,
                                                      r_ids),
                            p_eng.score_add_secondary(table, p_cid, cur_q,
                                                      p_ids)):
                check(b, a, torch_backend)
            r_ids = r_eng.register(cls)
            p_ids = p_eng.register([port_idx(i) for i in cls])
            for a, b in zip(r_eng.score_replace_clustered(table, r_sec,
                                                          r_ids),
                            p_eng.score_replace_clustered(table, p_sec,
                                                          p_ids)):
                check(b, a, torch_backend)


def test_config_costs_bitwise(env):
    ref, port, _, _, r_all = env
    r_eng, p_eng = engines(env, False)
    r_cfg, p_cfg = ref_base(ref.schema), base_configuration(port.schema)
    assert r_eng.config_cost(r_cfg) == p_eng.config_cost(p_cfg)
    for i in r_all[::5]:
        if i.clustered:
            old = r_cfg.clustered(i.table)
            rc = r_cfg.replace(old, i)
            pc = p_cfg.replace(port_idx(old), port_idx(i))
        else:
            rc, pc = r_cfg.add(i), p_cfg.add(port_idx(i))
        assert r_eng.config_cost(rc) == p_eng.config_cost(pc), i.label()


@pytest.mark.parametrize("variant", ["backtrack", "pure", "density"])
def test_greedy_enumerate_equals_reference(env, variant):
    ref, port, _, _, r_all = env
    r_eng, p_eng = engines(env, False)
    budget = 0.1 * sum(ref.sizes.size(i)
                       for i in ref_base(ref.schema).indexes)
    want = ref_greedy(ref.optimizer, ref.sizes, r_all, ref_base(ref.schema),
                      budget, variant=variant, engine=r_eng)
    got = greedy_enumerate(p_eng, port.sizes, [port_idx(i) for i in r_all],
                           base_configuration(port.schema), budget,
                           variant=variant)
    assert labels(got.config) == labels(want.config)
    assert (got.cost, got.used_bytes, got.steps) == \
        (want.cost, want.used_bytes, want.steps)


def test_configuration_and_engine_inputs(env):
    _, port, *_ = env
    eng = CostEngine(port.workload, port.sizes)
    cfg = Configuration.of([])
    with pytest.raises(ValueError, match="variant"):
        greedy_enumerate(eng, port.sizes, [], cfg, 0.0, variant="best")
