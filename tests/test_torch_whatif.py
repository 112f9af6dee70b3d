"""The what-if API (the paper's Figure-1 optimizer extension) in the port
against the JAX package: `WhatIfOptimizer.statement_cost` /
`workload_cost` `==` the reference's (the same float64 sums in statement
order), `workload_cost_batch` on the numpy route `==` the reference's
(configurations built as twins, `torch_config_twins`, so both packages'
engines sum in one order under every hash seed) and on the torch route
within rtol 1e-6; twins of `tests/test_cost_engine.py`'s
`TestConfigCostParity` (rel 1e-12 between the batched and the
statement-at-a-time costs) and of `test_backend_unified.py`'s
`WhatIfOptimizer` rebuild test; `Configuration.remove`,
`DesignAdvisor.optimizer` / `generate_candidates` and
`AdvisorSession.optimizer`."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import candidates as ref_cand
import repro_torch.core as pt
from repro_torch.core import candidates as cand
from torch_config_twins import port_index, twin_configs
from torch_port_util import port_schema, port_workload

CPU = torch.device("cpu")
ROUTES = [None, CPU]
ROUTE_IDS = ["numpy", "torch-cpu"]


def _rel_err(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture(scope="module")
def ref_schema():
    return rc.make_tpch_like(scale=0.3, z=0, seed=0)


@pytest.fixture(scope="module")
def ref_workload(ref_schema):
    return rc.make_tpch_workload(ref_schema, insert_weight=0.1)


@pytest.fixture(scope="module")
def workload(ref_workload):
    return port_workload(ref_workload)


def numpy_opts():
    return pt.AdvisorOptions(backend="numpy")


def route_opts(route):
    return numpy_opts() if route is None else \
        pt.AdvisorOptions(backend="torch", device="cpu")


@pytest.fixture(scope="module")
def single_index(ref_workload, workload):
    """The reference test's single-index configurations of the first
    query's NS / LDICT candidates, their sizes estimated by each package's
    advisor (numpy), as (reference advisor, port advisor, reference
    configurations, port twins)."""
    ref_adv = rc.DesignAdvisor(ref_workload)
    adv = pt.DesignAdvisor(workload, numpy_opts())
    ref_base = rc.base_configuration(ref_workload.schema)
    q = ref_workload.queries()[0]
    raw = ref_cand.syntactically_relevant(q, ref_workload.schema.tables[
        q.table])
    raw = ref_cand.expand_with_compression(raw, ("NS", "LDICT"))
    ref_adv.estimate_sizes(raw)
    adv.estimate_sizes([port_index(i) for i in raw])
    configs = []
    for idx in raw:
        if idx.clustered:
            configs.append(ref_base.replace(ref_base.clustered(idx.table),
                                            idx))
        else:
            configs.append(ref_base.add(idx))
    refs, ports = twin_configs([ref_base] + configs)
    return ref_adv, adv, refs, ports


def test_base_config_cost_matches_scalar(workload):
    adv = pt.DesignAdvisor(workload, numpy_opts())
    base = pt.base_configuration(workload.schema)
    engine = pt.CostEngine(workload, adv.sizes)
    assert _rel_err(engine.config_cost(base),
                    adv.optimizer.workload_cost(base)) < 1e-12


def test_single_index_configs_match_scalar(single_index):
    _, adv, _, configs = single_index
    engine = pt.CostEngine(adv.workload, adv.sizes)
    batched = engine.config_costs(configs)
    scalar = [adv.optimizer.workload_cost(c) for c in configs]
    np.testing.assert_allclose(batched, scalar, rtol=1e-12)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_workload_cost_batch_api(workload, route):
    adv = pt.DesignAdvisor(workload, route_opts(route))
    base = pt.base_configuration(workload.schema)
    out = adv.optimizer.workload_cost_batch([base, base])
    assert out.shape == (2,) and out.dtype == np.float64
    assert _rel_err(out[0], adv.optimizer.workload_cost(base)) < 1e-12
    assert adv.optimizer.engine().device == adv.device
    assert adv.optimizer.workload_cost_batch([]).shape == (0,)


def test_workload_cost_equals_reference(single_index):
    """Statement at a time, the port's float64 costs `==` the reference's,
    statement by statement and summed; the batched costs too, on the
    numpy route, with twin configurations."""
    ref_adv, adv, refs, ports = single_index
    for rcfg, cfg in zip(refs, ports):
        for rs, s in zip(ref_adv.workload.statements,
                         adv.workload.statements):
            assert adv.optimizer.statement_cost(s, cfg) == \
                ref_adv.optimizer.statement_cost(rs, rcfg), s.name
        assert adv.optimizer.workload_cost(cfg) == \
            ref_adv.optimizer.workload_cost(rcfg)
    np.testing.assert_array_equal(
        adv.optimizer.workload_cost_batch(ports),
        ref_adv.optimizer.workload_cost_batch(refs))
    assert adv.optimizer.calls == ref_adv.optimizer.calls


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_workload_cost_batch_on_route(single_index, route):
    ref_adv, adv, refs, ports = single_index
    opt = pt.WhatIfOptimizer(adv.workload, adv.sizes, device=route)
    want = ref_adv.optimizer.workload_cost_batch(refs)
    np.testing.assert_allclose(opt.workload_cost_batch(ports), want,
                               rtol=1e-6, atol=0.0)


def test_statement_cache_counts_calls(workload):
    adv = pt.DesignAdvisor(workload, numpy_opts())
    opt = adv.optimizer
    base = pt.base_configuration(workload.schema)
    n = len(workload.statements)
    c1 = opt.workload_cost(base)
    assert opt.calls == n
    assert opt.workload_cost(base) == c1 and opt.calls == n
    # an index on one table reprices only that table's statements
    q = workload.queries()[0]
    idx = pt.IndexDef(q.table, tuple(q.all_cols()))
    opt.workload_cost(base.add(idx))
    assert opt.calls == n + sum(1 for s in workload.statements
                                if s.table == q.table)


def test_engine_switch_rebuilds_instead_of_raising(workload):
    """Twin of the reference's backend-switch test: an explicit device
    other than the current engine's rebuilds it, a bare call reuses it."""
    adv = pt.DesignAdvisor(workload, numpy_opts())
    w = pt.WhatIfOptimizer(workload, adv.sizes)
    e1 = w.engine(None)
    assert e1.device is None
    e2 = w.engine(CPU)
    assert e2.device == CPU and e2 is not e1
    assert w.engine() is e2            # bare call reuses, never rebuilds
    e3 = w.engine(CPU)
    assert e3 is e2                    # same device: no rebuild
    e4 = w.engine(None)
    assert e4.device is None and e4 is not e2
    base = pt.base_configuration(workload.schema)
    assert np.isfinite(e4.config_cost(base))
    # built lazily on the optimizer's own device
    assert pt.WhatIfOptimizer(workload, adv.sizes, CPU).engine().device \
        == CPU


def test_configuration_remove(workload):
    base = pt.base_configuration(workload.schema)
    idx = pt.IndexDef("lineitem", ("l_shipdate",), "NS")
    cfg = base.add(idx)
    assert idx in cfg.indexes and cfg.remove(idx) == base
    assert base.remove(idx) == base


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_generate_candidates_equals_reference(ref_workload, workload, route):
    want = rc.DesignAdvisor(ref_workload).generate_candidates()
    got = pt.DesignAdvisor(workload, route_opts(route)).generate_candidates()
    assert [i.label() for i in got] == [i.label() for i in want]
    assert [i.key for i in got] == [port_index(i).key for i in want]


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_session_optimizer(workload, route):
    """The session's optimizer prices over the session's sizes, as a fresh
    advisor's does after the same recommendation."""
    opts = route_opts(route)
    budget = 0.25 * sum(
        t.nrows * (sum(c.width for c in t.columns) + 4)
        for t in workload.schema.tables.values())
    sess = pt.AdvisorSession(workload, opts)
    rec = sess.recommend(budget)
    adv = pt.DesignAdvisor(workload, opts)
    rec_a = adv.recommend(budget)
    assert sess.optimizer.sizes is sess.sizes
    assert sess.optimizer.device == sess.device
    assert sess.optimizer.workload_cost(rec.config) == \
        adv.optimizer.workload_cost(rec_a.config)
    assert _rel_err(sess.optimizer.workload_cost(rec.config), rec.cost) \
        < 1e-12


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_session_optimizer_follows_deltas(single_index, ref_workload,
                                          workload, route):
    """After a delta the session's optimizer prices the new workload, `==`
    the reference session's statement at a time, and its batched engine is
    rebuilt on it; after a recommendation re-registers sizes, its cached
    statement costs are those of a fresh optimizer on the same sizes."""
    _, _, refs, ports = single_index
    ref_sess = rc.AdvisorSession(ref_workload)
    sess = pt.AdvisorSession(workload, route_opts(route))
    before = sess.optimizer.workload_cost_batch(ports)
    for cfg in ports:
        sess.optimizer.workload_cost(cfg)
    q0, q1 = ref_workload.queries()[:2]
    p0 = workload.queries()[0]
    for s, new in ((ref_sess, dataclasses.replace(q0, name="q0_again")),
                   (sess, dataclasses.replace(p0, name="q0_again"))):
        s.remove_statements([q1.name])
        s.reweight({q0.name: 3.5})
        s.add_statements([new])
    assert sess.optimizer.workload is sess.workload
    for rcfg, cfg in zip(refs, ports):
        assert sess.optimizer.workload_cost(cfg) == \
            ref_sess.optimizer.workload_cost(rcfg)
    after = sess.optimizer.workload_cost_batch(ports)
    assert sess.optimizer.engine().workload is sess.workload
    assert not np.array_equal(after, before)
    want = ref_sess.optimizer.workload_cost_batch(refs)
    if route is None:
        np.testing.assert_array_equal(after, want)
    else:
        np.testing.assert_allclose(after, want, rtol=1e-6, atol=0.0)
    budget = 0.25 * sum(
        t.nrows * (sum(c.width for c in t.columns) + 4)
        for t in workload.schema.tables.values())
    sess.recommend(budget)
    fresh = pt.WhatIfOptimizer(sess.workload, sess.sizes)
    for cfg in ports:
        assert sess.optimizer.workload_cost(cfg) == fresh.workload_cost(cfg)
