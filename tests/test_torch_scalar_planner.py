"""The port's statement-at-a-time estimation paths against the JAX
package's: `errors.compose_batch`, the scalar §5.2 planner
(`greedy_scalar`, `plan_scalar`, `plan_all_sampled` and `greedy` with
`use_engine=False`, with and without §5.1 existing indexes) and
`execute_scalar` / `execute_cached(scalar=True)`.

Across the packages each scalar path is held to the reference's same path
on the same inputs: plans identical (`assert_identical`: states, chosen
deductions, RVs, total cost, node order), estimates `==`.  Inside the
port the batched engines are held to the scalar paths as the reference
holds its own (twins of `tests/test_core_estimation.py` and
`tests/test_estimation_engine.py`): the numpy route plan-identical and
byte-identical, the torch route on the CPU (the kernels' plain versions)
by the equal-p tie rule of `torch_port_util.assert_plans_match`."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as rc
from repro.core import errors as ref_err
from repro.core.estimation_graph import (EstimationPlanner as RefPlanner,
                                         NodeKey as RefKey)
import repro_torch.core as pt
from repro_torch.core import errors as E
from repro_torch.core.estimation_graph import (F_GRID, FORCE_ALL_Q,
                                               EstimationPlanner, NodeKey,
                                               State)
from repro_torch.core.planner_engine import assert_plan_identical
from torch_port_util import (assert_identical, assert_plans_match, port_key,
                             port_plan, port_schema, port_workload)

CPU = torch.device("cpu")
ROUTES = [None, CPU]
ROUTE_IDS = ["numpy", "torch-cpu"]

# the reference property test's (table, cols) pool
PLAN_POOL = (
    ("lineitem", ("l_shipdate",)),
    ("lineitem", ("l_quantity",)),
    ("lineitem", ("l_extendedprice",)),
    ("lineitem", ("l_shipdate", "l_quantity")),
    ("lineitem", ("l_quantity", "l_shipdate")),
    ("lineitem", ("l_shipdate", "l_extendedprice")),
    ("lineitem", ("l_shipdate", "l_extendedprice", "l_quantity")),
    ("lineitem", ("l_extendedprice", "l_shipdate", "l_quantity")),
    ("orders", ("o_orderdate",)),
    ("orders", ("o_orderdate", "o_totalprice")),
    ("orders", ("o_totalprice", "o_orderdate")),
)


def _draw_cases(n, seed=31):
    """The reference property test's strategy drawn from a fixed numpy
    seed: method, 1-6 distinct pool picks, a grid fraction, e in [0.05,
    1.5], q among the reference's (FORCE_ALL_Q included), with or without
    an existing index."""
    r = np.random.default_rng(seed)
    qs = (0.5, 0.8, 0.9, 0.99, FORCE_ALL_Q)
    cases = []
    for i in range(n):
        k = int(r.integers(1, 7))
        cases.append((str(r.choice(["NS", "LDICT"])),
                      tuple(int(x) for x in r.choice(11, k, replace=False)),
                      float(r.choice(F_GRID)),
                      float(r.uniform(0.05, 1.5)),
                      float(qs[int(r.integers(0, len(qs)))]),
                      bool(i % 2)))
    return cases


CASES = _draw_cases(12)


@pytest.fixture(scope="module")
def ref_schema():
    return rc.make_tpch_like(scale=0.2, z=0, seed=0)


@pytest.fixture(scope="module")
def schema(ref_schema):
    return port_schema(ref_schema)


def make_targets(key_cls, method="NS", n=4):
    """The reference engine test's targets."""
    cols = [("lineitem", ("l_shipdate",)), ("lineitem", ("l_extendedprice",)),
            ("lineitem", ("l_shipdate", "l_extendedprice")),
            ("lineitem", ("l_shipdate", "l_extendedprice", "l_quantity")),
            ("orders", ("o_orderdate",)),
            ("orders", ("o_orderdate", "o_totalprice"))]
    return [key_cls(t, c, method) for t, c in cols[:n]]


@pytest.fixture(scope="module")
def advisor_targets(ref_schema):
    """The reference engine test's advisor targets (60 statements, seed
    0), as (reference keys, port keys)."""
    wl = rc.make_scaled_workload(ref_schema, n_statements=60, seed=0)
    _, _, cands = rc.DesignAdvisor(wl, rc.AdvisorOptions.dtac()) \
        ._candidate_universe()
    ref = list(rc.DesignAdvisor.estimation_targets(cands))
    return ref, [port_key(k) for k in ref]


def assert_route_matches(got, want, route, e):
    """numpy: plan-identical to the port's scalar plan; torch: the equal-p
    tie rule."""
    if route is None:
        assert_plan_identical(want, got)
        assert list(got.nodes) == list(want.nodes)
    else:
        assert_plans_match(got, want, e, exact_rv=False)


# ---------------------------------------------------------------------------
# compose_batch (twins of test_core_estimation.py's TestErrors properties)
# ---------------------------------------------------------------------------

RV = st.tuples(st.floats(0.2, 2.5), st.floats(0.0, 0.6))


@given(st.lists(RV, min_size=0, max_size=7))
@settings(max_examples=60, deadline=None)
def test_property_compose_batch_bit_identical(pairs):
    """compose_batch == the scalar compose folded in order, bit for bit,
    and == the reference's compose_batch."""
    want = E.compose([E.ErrorRV(m, s) for m, s in pairs])
    means = np.array([m for m, _ in pairs])
    stds = np.array([s for _, s in pairs])
    gm, gs = E.compose_batch(means, stds)
    assert float(gm) == want.mean and float(gs) == want.std
    rm, rs = ref_err.compose_batch(means, stds)
    assert gm.tobytes() == rm.tobytes() and gs.tobytes() == rs.tobytes()


@given(st.lists(st.lists(RV, min_size=3, max_size=3), min_size=1,
                max_size=5))
@settings(max_examples=40, deadline=None)
def test_property_compose_batch_rows(rows):
    """Row-stacked compose_batch == per-row scalar compose; EXACT padding
    is a bitwise no-op; == the reference's along axis 1 and axis 0."""
    means = np.array([[m for m, _ in row] for row in rows])
    stds = np.array([[s for _, s in row] for row in rows])
    pad_m = np.concatenate([means, np.ones((len(rows), 2))], axis=1)
    pad_s = np.concatenate([stds, np.zeros((len(rows), 2))], axis=1)
    gm, gs = E.compose_batch(means, stds, axis=1)
    pm, ps_ = E.compose_batch(pad_m, pad_s, axis=1)
    assert np.array_equal(gm, pm) and np.array_equal(gs, ps_)
    for i, row in enumerate(rows):
        want = E.compose([E.ErrorRV(m, s) for m, s in row])
        assert (gm[i], gs[i]) == (want.mean, want.std)
    for axis in (0, 1):
        got = E.compose_batch(means, stds, axis=axis)
        ref = ref_err.compose_batch(means, stds, axis=axis)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got, ref))


# ---------------------------------------------------------------------------
# the scalar greedy, across the packages and against the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[f"case{i}"
                                             for i in range(len(CASES))])
def test_greedy_scalar_equals_reference_and_engines(ref_schema, schema,
                                                    case):
    """The port's greedy_scalar plan-identical to the reference's on the
    same draw (randomized target sets, fractions, (e, q), FORCE_ALL_Q,
    an EXACT existing node); the numpy engine plan-identical to it, the
    torch engine on the CPU by the tie rule (twin of
    test_property_batched_planner_plan_identical); `greedy` with
    `use_engine=False` is greedy_scalar."""
    method, picks, f, e, q, with_existing = case
    rt = [RefKey(t, c, method) for t, c in (PLAN_POOL[i] for i in picks)]
    ref_ex = {RefKey("lineitem", ("l_shipdate",), method): 4321.0} \
        if with_existing else {}
    ex = {port_key(k): b for k, b in ref_ex.items()}
    targets = [port_key(k) for k in rt]
    want = RefPlanner(ref_schema.tables, existing=ref_ex) \
        .greedy_scalar(rt, f, e, q)
    got = EstimationPlanner(schema.tables, existing=ex) \
        .greedy_scalar(targets, f, e, q)
    assert_identical(got, want)
    off = EstimationPlanner(schema.tables, existing=ex, device=CPU,
                            use_engine=False)
    assert_identical(off.greedy(targets, f, e, q), want)
    for route in ROUTES:
        eng = EstimationPlanner(schema.tables, existing=ex, device=route)
        assert_route_matches(eng.engine.greedy_batch(targets, e, q, (f,))[0],
                             got, route, e)
    for k, size in ex.items():
        assert got.nodes[k].state is State.EXACT
        assert got.nodes[k].exact_bytes == size


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_greedy_batch_plan_identical_over_grid(ref_schema, schema,
                                               advisor_targets, route):
    """Twin of test_greedy_batch_plan_identical_over_grid: the engine's
    one pass over F_GRID against greedy_scalar at each fraction; the
    port's greedy_scalar == the reference's at each."""
    ref_t, targets = advisor_targets
    planner = EstimationPlanner(schema.tables, device=route)
    ref = RefPlanner(ref_schema.tables)
    batched = planner.engine.greedy_batch(targets, 0.5, 0.9, F_GRID)
    assert any(p.n_deduced() for p in batched)  # non-trivial plans
    for f, got in zip(F_GRID, batched):
        scalar = planner.greedy_scalar(targets, f, 0.5, 0.9)
        if route is None:
            assert_identical(scalar, ref.greedy_scalar(ref_t, f, 0.5, 0.9))
        assert_route_matches(got, scalar, route, 0.5)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_plan_matches_plan_scalar(ref_schema, schema, advisor_targets,
                                  route):
    """Twin of test_plan_matches_plan_scalar: `plan` (the engine) against
    `plan_scalar` (the grid loop) at three (e, q); `plan_scalar` and
    `plan` with `use_engine=False` == the reference's `plan_scalar`."""
    ref_t, targets = advisor_targets
    planner = EstimationPlanner(schema.tables, device=route)
    ref = RefPlanner(ref_schema.tables)
    off = EstimationPlanner(schema.tables, device=route, use_engine=False)
    for e, q in ((0.5, 0.9), (0.05, 0.99), (1.0, 0.8)):
        scalar = planner.plan_scalar(targets, e, q)
        assert planner.use_engine
        if route is None:
            assert_identical(scalar, ref.plan_scalar(ref_t, e, q))
        assert_plan_identical(scalar, off.plan(targets, e, q))
        assert_route_matches(planner.plan(targets, e, q), scalar, route, e)
    assert off._engine is None     # the scalar path builds no engine


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_plan_all_sampled_matches_scalar(ref_schema, schema, route):
    """Twin of test_plan_all_sampled_matches_scalar (LDICT, two (e, q)),
    and the port's scalar "All" baseline == the reference's."""
    planner = EstimationPlanner(schema.tables, device=route)
    ref = RefPlanner(ref_schema.tables, use_engine=False)
    targets = make_targets(NodeKey, "LDICT", 4)
    for e, q in ((0.2, 0.9), (0.05, 0.99)):
        got = planner.plan_all_sampled(targets, e, q)
        planner.use_engine = False
        want = planner.plan_all_sampled(targets, e, q)
        planner.use_engine = True
        assert_identical(want, ref.plan_all_sampled(
            make_targets(RefKey, "LDICT", 4), e, q))
        assert_route_matches(got, want, route, e)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_force_all_q_and_existing(ref_schema, schema, route):
    """Twins of test_force_all_q_parity and test_existing_exact_nodes:
    the engine against greedy_scalar under FORCE_ALL_Q (no deduction
    anywhere) and with two EXACT existing nodes, the scalar plans == the
    reference's."""
    targets = make_targets(NodeKey, "NS", 6)
    rt = make_targets(RefKey, "NS", 6)
    planner = EstimationPlanner(schema.tables, device=route)
    ref = RefPlanner(ref_schema.tables)
    for f in F_GRID:
        got = planner.engine.greedy_batch(targets, 0.3, FORCE_ALL_Q, (f,))[0]
        scalar = planner.greedy_scalar(targets, f, 0.3, FORCE_ALL_Q)
        assert_identical(scalar, ref.greedy_scalar(rt, f, 0.3, FORCE_ALL_Q))
        assert_route_matches(got, scalar, route, 0.3)
        assert got.n_deduced() == 0
    ref_ex = {RefKey("lineitem", ("l_shipdate",), "NS"): 12345.0,
              RefKey("lineitem", ("l_shipdate", "l_extendedprice"),
                     "NS"): 99.0}
    ex = {port_key(k): b for k, b in ref_ex.items()}
    planner = EstimationPlanner(schema.tables, existing=ex, device=route)
    ref = RefPlanner(ref_schema.tables, existing=ref_ex)
    for f in (0.01, 0.05):
        got = planner.engine.greedy_batch(targets[:4], 0.5, 0.9, (f,))[0]
        scalar = planner.greedy_scalar(targets[:4], f, 0.5, 0.9)
        assert_identical(scalar, ref.greedy_scalar(rt[:4], f, 0.5, 0.9))
        assert_route_matches(got, scalar, route, 0.5)
        for k, size in ex.items():
            assert got.nodes[k].state is State.EXACT
            assert got.nodes[k].exact_bytes == size


# ---------------------------------------------------------------------------
# execute_scalar: one sample_cf per SAMPLED node
# ---------------------------------------------------------------------------

def assert_estimates_equal(got, want):
    assert list(got) == list(want)
    for k, ref in want.items():
        g = got[k]
        assert (g.est_bytes, g.cf, g.cost_pages, g.method) == \
            (ref.est_bytes, ref.cf, ref.cost_pages, ref.method), k.label()
        assert g.index == ref.index


def assert_estimates_equal_ref(got, ref_ests):
    assert [k.label() for k in got] == [k.label() for k in ref_ests]
    for (k, g), r in zip(got.items(), ref_ests.values()):
        assert (g.est_bytes, g.cf, g.cost_pages, g.method) == \
            (r.est_bytes, r.cf, r.cost_pages, r.method), k.label()


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_execute_matches_execute_scalar(ref_schema, schema, advisor_targets,
                                        route):
    """Twin of test_execute_matches_execute_scalar: the batched execute
    (numpy, and the codec kernels' plain versions on the CPU) == the
    scalar execute on the reference's plan; the port's execute_scalar ==
    the reference's."""
    ref_t, targets = advisor_targets
    ref = RefPlanner(ref_schema.tables)
    ref_plan = ref.plan(ref_t, 0.5, 0.9)
    plan = port_plan(ref_plan)
    planner = EstimationPlanner(schema.tables)
    assert any(n.state is State.SAMPLED for n in plan.nodes.values())
    ests_s = planner.execute_scalar(plan, pt.SampleManager(schema.tables,
                                                           seed=0))
    ests_b = planner.execute(plan, pt.EstimationEngine(
        schema.tables, pt.SampleManager(schema.tables, seed=0), route))
    assert_estimates_equal(ests_b, ests_s)
    assert_estimates_equal_ref(ests_s, ref.execute_scalar(
        ref_plan, rc.SampleManager(ref_schema.tables, seed=0)))


@pytest.mark.parametrize("method", ["NS", "LDICT"])
def test_optimal_plan_executes_scalar_and_cached(ref_schema, schema,
                                                 method):
    """Twins of test_optimal_plan_executes_through_batched_engine and
    test_optimal_execute_cached_matches_scalar: an Appendix D plan run by
    execute_scalar, by the batched execute on both routes and by
    execute_cached, batched and scalar: all `==`, == the reference's
    execute_scalar; a second cached call estimates nothing."""
    targets = make_targets(NodeKey, method, 6)
    planner = EstimationPlanner(schema.tables)
    plan = planner.optimal(targets, 0.05, 0.8, 0.85)
    assert any(n.state is State.SAMPLED for n in plan.nodes.values())
    want = planner.execute_scalar(plan, pt.SampleManager(schema.tables,
                                                         seed=0))
    ref = RefPlanner(ref_schema.tables)
    ref_plan = ref.optimal(make_targets(RefKey, method, 6), 0.05, 0.8, 0.85)
    assert_identical(plan, ref_plan)
    assert_estimates_equal_ref(want, ref.execute_scalar(
        ref_plan, rc.SampleManager(ref_schema.tables, seed=0)))
    n_sampled = plan.n_sampled()
    for route in ROUTES:
        eng = pt.EstimationEngine(schema.tables,
                                  pt.SampleManager(schema.tables, seed=0),
                                  route)
        assert_estimates_equal(planner.execute(plan, eng), want)
        for scalar in (False, True):
            cache = {}
            got = planner.execute_cached(plan, cache, eng, scalar=scalar)
            assert len(cache) == n_sampled
            assert_estimates_equal(got, want)
            calls = []
            est_batch = eng.estimate_batch
            eng.estimate_batch = lambda *a: calls.append(a) or est_batch(*a)
            try:
                again = planner.execute_cached(plan, cache, eng,
                                               scalar=scalar)
            finally:
                eng.estimate_batch = est_batch
            assert calls == [] and len(cache) == n_sampled
            assert_estimates_equal(again, want)


# ---------------------------------------------------------------------------
# the advisor's estimation switches (estimate_sizes)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sized(ref_schema, schema):
    """estimate_sizes of the reference's 40-statement workload (seed 1)
    under each switch, per package and route."""
    ref_wl = rc.make_scaled_workload(ref_schema, n_statements=40, seed=1)
    wl = port_workload(ref_wl, schema)
    out = {}
    for name, kw in (("batched", {}),
                     ("scalar_est", dict(use_batched_estimation=False)),
                     ("scalar_plan", dict(use_batched_planner=False))):
        adv = rc.DesignAdvisor(ref_wl, dataclasses.replace(
            rc.AdvisorOptions.dtac(), **kw))
        cands = adv._candidate_universe()[2]
        out["ref", name] = (adv, cands, adv.estimate_sizes(cands))
        for route, opts in (("numpy", dict(backend="numpy")),
                            ("torch-cpu", dict(device="cpu"))):
            adv = pt.DesignAdvisor(wl, pt.AdvisorOptions(**opts, **kw))
            cands = adv._candidate_universe()[2]
            out[route, name] = (adv, cands, adv.estimate_sizes(cands))
    return out


@pytest.mark.parametrize("name", ["scalar_est", "scalar_plan"])
@pytest.mark.parametrize("route", ["numpy", "torch-cpu"])
def test_estimate_sizes_switches(sized, route, name):
    """Twins of test_estimate_sizes_batched_equals_scalar and
    test_estimate_sizes_planner_toggle_parity: each switch gives the
    batched run's (cost, sampled, deduced), fraction and every compressed
    candidate's size, on both routes; on numpy every size == the
    reference's under the same switch."""
    adv_b, cands, (cost_b, plan_b, ns_b, nd_b) = sized[route, "batched"]
    adv_s, _, (cost_s, plan_s, ns_s, nd_s) = sized[route, name]
    assert (cost_b, ns_b, nd_b) == (cost_s, ns_s, nd_s)
    assert plan_b.f == plan_s.f
    ref_adv, ref_cands, ref_res = sized["ref", name]
    assert (ref_res[0], ref_res[2], ref_res[3]) == (cost_s, ns_s, nd_s)
    for idx, ridx in zip(cands, ref_cands):
        if idx.compression is None:
            continue
        assert idx.label() == ridx.label()
        assert adv_b.sizes.size(idx) == adv_s.sizes.size(idx)
        if route == "numpy":
            assert adv_s.sizes.size(idx) == ref_adv.sizes.size(ridx)
