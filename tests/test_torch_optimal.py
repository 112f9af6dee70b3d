"""Appendix D's Optimal planner and the one-fraction greedy
(`EstimationPlanner.optimal` / `greedy`) of the port against the JAX
package's: on the numpy planner every plan `==` the reference's (states,
chosen deductions, error RVs, total cost), on the torch planner (the
walk's plain version on the CPU) the greedy within the equal-p tie rule
and Optimal's plans `==`; the reference tests' assertions (Optimal <=
greedy <= all-sampled, (e, q) met whenever feasible, infeasibility
flagged); one planner_walk a greedy on the torch route; Table 4's
yardstick at a small size."""
import pytest
import torch

import repro.core as rc
from repro.core.estimation_graph import EstimationPlanner as RefPlanner, \
    NodeKey as RefKey
import repro_torch.core as pt
from repro_torch.core import errors as E
from repro_torch.core.estimation_graph import (F_GRID, EstimationPlanner,
                                               NodeKey, State,
                                               candidate_deductions,
                                               sampling_cost)
from repro_torch.kernels import planner_score as ps
from torch_port_util import assert_plans_match, port_schema

CPU = torch.device("cpu")
TABLE4_COLS = ("l_shipdate", "l_returnflag", "l_extendedprice",
               "l_quantity", "l_discount")


@pytest.fixture(scope="module")
def ref_schema():
    return rc.make_tpch_like(scale=0.5, z=0, seed=0)


@pytest.fixture(scope="module")
def schema(ref_schema):
    return port_schema(ref_schema)


def make_targets(key_cls, method="NS", n=4):
    """The reference test's targets: lineitem and orders indexes."""
    cols = [("l_shipdate",), ("l_extendedprice",),
            ("l_shipdate", "l_extendedprice"),
            ("l_shipdate", "l_extendedprice", "l_quantity"),
            ("o_orderdate",), ("o_orderdate", "o_totalprice")]
    return [key_cls("orders" if c[0].startswith("o_") else "lineitem", c,
                    method) for c in cols[:n]]


def table4_targets(key_cls):
    return [key_cls("lineitem", TABLE4_COLS[:i], m)
            for i in range(1, len(TABLE4_COLS) + 1) for m in ("NS", "LDICT")]


def plan_summary(plan):
    return (plan.f, plan.total_cost, plan.feasible,
            [(k.label(), n.state.value,
              None if n.chosen is None else
              (n.chosen.kind, tuple(c.label() for c in n.chosen.children)),
              n.rv.mean, n.rv.std) for k, n in plan.nodes.items()])


CASES = [("NS", 0.8, 0.85, 0.05), ("NS", 0.3, 0.9, 0.10),
         ("LDICT", 1.0, 0.8, 0.05), ("LDICT", 0.5, 0.9, 0.10),
         ("LDICT", 0.05, 0.99, 0.10), ("NS", 0.5, 0.9, 0.01)]


@pytest.mark.parametrize("method,e,q,f", CASES)
def test_optimal_and_greedy_equal_reference(ref_schema, schema, method, e,
                                            q, f):
    ref = RefPlanner(ref_schema.tables)
    port = EstimationPlanner(schema.tables)
    dev = EstimationPlanner(schema.tables, device=CPU)
    for n in (3, 6):
        rt, pt_ = make_targets(RefKey, method, n), \
            make_targets(NodeKey, method, n)
        want_o = plan_summary(ref.optimal(rt, f, e, q))
        assert plan_summary(port.optimal(pt_, f, e, q)) == want_o
        assert plan_summary(dev.optimal(pt_, f, e, q))[:2] == want_o[:2]
        want_g = ref.greedy(rt, f, e, q)
        assert plan_summary(port.greedy(pt_, f, e, q)) == \
            plan_summary(want_g)
        assert_plans_match(dev.greedy(pt_, f, e, q), want_g, e,
                           exact_rv=False)


@pytest.mark.parametrize("e", [0.5, 1.0])
def test_table4_greedy_vs_optimal_equal_reference(ref_schema, schema, e):
    """Table 4's ten lineitem targets at each grid fraction: greedy on
    all ten and on the first eight, Optimal on the first eight."""
    ref = RefPlanner(ref_schema.tables)
    port = EstimationPlanner(schema.tables)
    rt, ptg = table4_targets(RefKey), table4_targets(NodeKey)
    for f in F_GRID:
        for n in (10, 8):
            assert plan_summary(port.greedy(ptg[:n], f, e, 0.9)) == \
                plan_summary(ref.greedy(rt[:n], f, e, 0.9))
        o = port.optimal(ptg[:8], f, e, 0.9)
        assert plan_summary(o) == plan_summary(ref.optimal(rt[:8], f, e, 0.9))
        assert o.total_cost <= port.greedy(ptg[:8], f, e, 0.9).total_cost


@pytest.mark.parametrize("method,e,q", [c[:3] for c in CASES[:4]])
def test_optimal_not_worse_and_bounded_by_all_sampled(schema, method, e,
                                                      q):
    planner = EstimationPlanner(schema.tables)
    targets = make_targets(NodeKey, method, 6)
    for f in (0.05, 0.10):
        g = planner.greedy(targets, f, e, q)
        o = planner.optimal(targets, f, e, q)
        all_cost = sum(sampling_cost(schema.tables[t.table], t, f)
                       for t in targets)
        assert o.total_cost <= g.total_cost + 1e-9
        assert g.total_cost <= all_cost + 1e-9   # §5.2 greedy bound
        for plan in (g, o):
            if plan.feasible:
                for t in targets:
                    assert E.satisfies(plan.nodes[t].rv, e, q)


def test_feasible_case_agrees(schema):
    planner = EstimationPlanner(schema.tables)
    targets = make_targets(NodeKey, "NS", 4)
    g = planner.greedy(targets, 0.05, 0.8, 0.85)
    o = planner.optimal(targets, 0.05, 0.8, 0.85)
    assert g.feasible and o.feasible


def test_infeasible_flagged_by_both(schema):
    """e/q so tight that even SampleCF cannot meet the bound for ORD-DEP
    methods: every plan is flagged infeasible (Optimal falls back to
    greedy)."""
    planner = EstimationPlanner(schema.tables)
    targets = make_targets(NodeKey, "LDICT", 4)
    assert not E.satisfies(E.samplecf_error("LDICT", 0.10), 0.05, 0.99)
    assert not planner.greedy(targets, 0.10, 0.05, 0.99).feasible
    assert not planner.optimal(targets, 0.10, 0.05, 0.99).feasible
    assert not planner.plan(targets, 0.05, 0.99).feasible


def test_optimal_rejects_too_many_targets(schema):
    planner = EstimationPlanner(schema.tables)
    with pytest.raises(ValueError):
        planner.optimal(table4_targets(NodeKey), 0.05, 0.5, 0.9,
                        max_nodes=9)


@pytest.mark.parametrize("method", ["NS", "LDICT"])
def test_optimal_plan_executes_through_batched_engine(ref_schema, schema,
                                                      method):
    """App. D plans run through the batched EstimationEngine like greedy
    plans, the estimates `==` the reference's execute of its own plan."""
    ref = RefPlanner(ref_schema.tables)
    port = EstimationPlanner(schema.tables)
    plan = port.optimal(make_targets(NodeKey, method, 6), 0.05, 0.8, 0.85)
    assert any(n.state is State.SAMPLED for n in plan.nodes.values())
    got = port.execute(plan, pt.EstimationEngine(
        schema.tables, pt.SampleManager(schema.tables, seed=0)))
    want = ref.execute(ref.optimal(make_targets(RefKey, method, 6), 0.05,
                                   0.8, 0.85),
                       rc.SampleManager(ref_schema.tables, seed=0))
    assert sorted(k.label() for k in got) == sorted(k.label() for k in want)
    by_label = {k.label(): v for k, v in want.items()}
    for k, est in got.items():
        ref_est = by_label[k.label()]
        assert (est.est_bytes, est.cf, est.cost_pages, est.method) == \
            (ref_est.est_bytes, ref_est.cf, ref_est.cost_pages,
             ref_est.method)


def test_greedy_is_one_walk_on_the_torch_route(schema, monkeypatch):
    calls = []
    walk = ps.planner_walk

    def counting(*a, **kw):
        calls.append(a[0].scost.shape[1])
        return walk(*a, **kw)
    monkeypatch.setattr(ps, "planner_walk", counting)
    planner = EstimationPlanner(schema.tables, device=CPU)
    targets = table4_targets(NodeKey)
    for f in F_GRID:
        planner.greedy(targets, f, 0.5, 0.9)
    planner.optimal(targets[:4], 0.05, 0.5, 0.9)
    assert calls == [1] * len(F_GRID)      # one fraction a walk
    planner.plan(targets, 0.5, 0.9)
    assert calls[-1] == len(F_GRID)


def test_candidate_deductions_equal_reference():
    from repro.core.estimation_graph import candidate_deductions as ref_cd
    for method in ("NS", "LDICT", "GDICT"):
        key = NodeKey("t", ("a", "b", "c"), method)
        present = [NodeKey("t", ("c", "a", "b"), method),
                   NodeKey("t", ("b", "a", "c"), method),
                   NodeKey("t", ("a", "b"), method),
                   NodeKey("u", ("a", "b", "c"), method)]
        rkey = RefKey("t", ("a", "b", "c"), method)
        rpresent = [RefKey(p.table, p.cols, p.method) for p in present]
        got = [(d.kind, [c.label() for c in d.children], d.parts)
               for d in candidate_deductions(key, present)]
        want = [(d.kind, [c.label() for c in d.children], d.parts)
                for d in ref_cd(rkey, rpresent)]
        assert got == want
