"""Existing indexes (§5.1) in the port against the JAX package: indexes
that already exist enter every estimation plan EXACT, with their true
size, at no sampling cost and no error.

`EstimationPlanner(existing=)` / `PlannerEngine(existing=)` on the numpy
route are plan-identical (`assert_plan_identical`) to the reference's
engine and its scalar greedy with the same `existing`; on the torch route
(the walk's plain version on the CPU) they match by the equal-p tie rule,
their exact nodes EXACT with their bytes.  Twins of the reference's
`test_existing_index_is_free`, `test_existing_exact_nodes` and the
`with_existing` cases of `test_property_batched_planner_plan_identical`
(cases drawn from a fixed seed), `optimal` and `exact_size` `==` the
reference's, and `planner_walk_plain` with exact ids against the same
walk with those nodes' rows preset by hand."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import samplecf as ref_scf
from repro.core.estimation_graph import (EstimationPlanner as RefPlanner,
                                         FORCE_ALL_Q, NodeKey as RefKey)
import repro_torch.core as pt
from repro_torch.core import samplecf as scf
from repro_torch.core.estimation_graph import (F_GRID, EstimationPlanner,
                                               NodeKey, State)
from repro_torch.core.planner_engine import PlannerEngine
from repro_torch.kernels import planner_score as ps
from torch_port_util import (assert_identical, assert_plans_match,
                             port_key, port_schema, walk_graph,
                             walk_synthetic, WALK_TIES)

CPU = torch.device("cpu")
ROUTES = [None, CPU]
ROUTE_IDS = ["numpy", "torch-cpu"]
E_, Q_ = 0.5, 0.9

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


def _draw_cases(n, seed=20301):
    """The property test's strategy drawn from a fixed numpy seed: method,
    1-6 distinct pool picks, a grid fraction, e in [0.05, 1.5] and q among
    the reference's, FORCE_ALL_Q included."""
    r = np.random.default_rng(seed)
    qs = (0.5, 0.8, 0.9, 0.99, FORCE_ALL_Q)
    cases = []
    for _ in range(n):
        k = int(r.integers(1, 7))
        cases.append((str(r.choice(["NS", "LDICT"])),
                      tuple(int(x) for x in r.choice(11, k, replace=False)),
                      float(r.choice(F_GRID)),
                      float(r.uniform(0.05, 1.5)),
                      float(qs[int(r.integers(0, len(qs)))])))
    return cases


CASES = _draw_cases(16)


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


def assert_route_matches(got, ref, route, e, existing):
    """numpy: plan-identical; torch: the equal-p tie rule.  Either way
    every existing node EXACT with its bytes."""
    if route is None:
        assert_identical(got, ref)
    else:
        assert_plans_match(got, ref, e, exact_rv=False)
    for k, size in existing.items():
        assert got.nodes[k].state is State.EXACT
        assert got.nodes[k].exact_bytes == size
        assert (got.nodes[k].rv.mean, got.nodes[k].rv.std) == (1.0, 0.0)


def existing_pair(items):
    """({reference NodeKey: bytes}, {port NodeKey: bytes})."""
    ref = {RefKey(t, c, m): b for (t, c, m), b in items}
    return ref, {port_key(k): b for k, b in ref.items()}


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_existing_index_is_free(ref_schema, schema, route):
    ref_ex, ex = existing_pair([(("lineitem", ("l_shipdate",), "NS"),
                                 12345.0)])
    t = next(iter(ex))
    planner = EstimationPlanner(schema.tables, existing=ex, device=route)
    plan = planner.greedy([t], f=0.05, e=E_, q=Q_)
    assert plan.nodes[t].state is State.EXACT
    assert plan.total_cost == 0.0
    eng = pt.EstimationEngine(schema.tables,
                              pt.SampleManager(schema.tables), route)
    est = planner.execute(plan, eng)[t]
    assert est.est_bytes == 12345.0 and est.cost_pages == 0.0
    assert est.method == "exact"
    rt = next(iter(ref_ex))
    ref = RefPlanner(ref_schema.tables, existing=ref_ex).greedy(
        [rt], 0.05, E_, Q_)
    assert_route_matches(plan, ref, route, E_, ex)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_existing_exact_nodes(ref_schema, schema, route):
    items = [(("lineitem", ("l_shipdate",), "NS"), 12345.0),
             (("lineitem", ("l_shipdate", "l_extendedprice"), "NS"), 99.0)]
    ref_ex, ex = existing_pair(items)
    ref = RefPlanner(ref_schema.tables, existing=ref_ex)
    planner = EstimationPlanner(schema.tables, existing=ex, device=route)
    rt, tg = make_targets(RefKey, "NS", 4), make_targets(NodeKey, "NS", 4)
    for f in (0.01, 0.05):
        want = ref.engine.greedy_batch(rt, E_, Q_, (f,))[0]
        got = planner.engine.greedy_batch(tg, E_, Q_, (f,))[0]
        assert_route_matches(got, want, route, E_, ex)
        if route is None:
            assert_identical(got, ref.greedy_scalar(rt, f, E_, Q_))
        # the existing nodes come first, as in the reference
        assert list(got.nodes)[:2] == list(ex)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("case", CASES,
                         ids=[f"case{i}" for i in range(len(CASES))])
def test_batched_planner_plan_identical_with_existing(ref_schema, schema,
                                                      case, route):
    """The reference property test's with_existing cases: the port's
    engine against the reference's engine and its scalar greedy."""
    method, picks, f, e, q = case
    pool = [PLAN_POOL[i] for i in picks]
    ref_ex, ex = existing_pair([(("lineitem", ("l_shipdate",), method),
                                 4321.0)])
    ref = RefPlanner(ref_schema.tables, existing=ref_ex)
    rt = [RefKey(t, c, method) for t, c in pool]
    want = ref.engine.greedy_batch(rt, e, q, (f,))[0]
    port = EstimationPlanner(schema.tables, existing=ex, device=route)
    got = port.engine.greedy_batch([port_key(k) for k in rt], e, q, (f,))[0]
    assert_route_matches(got, want, route, e, ex)
    if route is None:
        assert_identical(got, ref.greedy_scalar(rt, f, e, q))


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("method", ["NS", "LDICT"])
def test_plan_and_all_sampled_with_existing(ref_schema, schema, method,
                                            route):
    items = [(("lineitem", ("l_extendedprice",), method), 777.0),
             (("orders", ("o_orderdate",), method), 4242.0)]
    ref_ex, ex = existing_pair(items)
    ref = RefPlanner(ref_schema.tables, existing=ref_ex)
    port = EstimationPlanner(schema.tables, existing=ex, device=route)
    rt, tg = make_targets(RefKey, method, 6), make_targets(NodeKey, method, 6)
    for e, q in ((0.5, 0.9), (0.05, 0.99), (1.0, 0.8)):
        assert_route_matches(port.plan(tg, e, q), ref.plan(rt, e, q), route,
                             e, ex)
        assert_route_matches(port.plan_all_sampled(tg, e, q),
                             ref.plan_all_sampled(rt, e, q), route, e, ex)
    # an existing target costs nothing and is EXACT in the plan
    plan = port.plan(tg, E_, Q_)
    k = port_key(next(iter(ref_ex)))
    assert plan.nodes[k].state is State.EXACT
    assert plan.states()[k] is State.EXACT
    assert {x.label(): s.value for x, s in plan.states().items()} == \
        {x.label(): n.state.value for x, n in plan.nodes.items()}


def plan_summary(plan):
    return (plan.f, plan.total_cost, plan.feasible,
            [(k.label(), n.state.value, n.exact_bytes,
              None if n.chosen is None else
              (n.chosen.kind, tuple(c.label() for c in n.chosen.children)),
              n.rv.mean, n.rv.std) for k, n in plan.nodes.items()])


@pytest.mark.parametrize("method,e,q,f", [("NS", 0.8, 0.85, 0.05),
                                          ("LDICT", 0.5, 0.9, 0.10),
                                          ("NS", 0.3, 0.9, 0.01)])
def test_optimal_with_existing_equals_reference(ref_schema, schema, method,
                                                e, q, f):
    """As in the reference, Optimal may still sample an existing target;
    an existing node that is not a target stays EXACT."""
    items = [(("lineitem", ("l_shipdate",), method), 5000.0),
             (("lineitem", ("l_quantity",), method), 6000.0)]
    ref_ex, ex = existing_pair(items)
    ref = RefPlanner(ref_schema.tables, existing=ref_ex)
    port = EstimationPlanner(schema.tables, existing=ex)
    for n in (3, 4):
        rt, tg = make_targets(RefKey, method, n), \
            make_targets(NodeKey, method, n)
        got = port.optimal(tg, f, e, q)
        assert plan_summary(got) == plan_summary(ref.optimal(rt, f, e, q))
        k = port_key(RefKey("lineitem", ("l_quantity",), method))
        assert got.nodes[k].state is State.EXACT
        assert got.nodes[k].exact_bytes == 6000.0


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("method", ["NS", "GDICT", "LDICT", "PREFIX",
                                    "RLE"])
def test_exact_size_equals_reference(ref_schema, schema, method, route):
    for cols in (("l_shipdate",), ("l_shipdate", "l_extendedprice")):
        want = ref_scf.exact_size(ref_schema.tables["lineitem"],
                                  rc.IndexDef("lineitem", cols, method))
        idx = pt.IndexDef("lineitem", cols, method)
        got = scf.exact_size(schema.tables["lineitem"], idx, route)
        assert (got.est_bytes, got.method, got.cost_pages, got.cf) == \
            (want.est_bytes, want.method, want.cost_pages, want.cf)
        assert got.index == idx and got.method == "exact"


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_execute_with_existing_equals_reference(ref_schema, schema, route):
    """Executed sizes of the numpy plan: every node `==` the reference's
    `execute` (exact nodes their bytes, SampleCF on the same samples,
    deductions from those), the estimation engine on the route."""
    method = "LDICT"
    items = [(("lineitem", ("l_shipdate",), method), 31337.0),
             (("lineitem", ("l_shipdate", "l_extendedprice"), method),
              99.0)]
    ref_ex, ex = existing_pair(items)
    ref = RefPlanner(ref_schema.tables, existing=ref_ex)
    port = EstimationPlanner(schema.tables, existing=ex)
    rt, tg = make_targets(RefKey, method, 6), make_targets(NodeKey, method, 6)
    ref_plan = ref.plan(rt, 0.3, 0.9)
    plan = port.plan(tg, 0.3, 0.9)
    assert_identical(plan, ref_plan)
    want = ref.execute(ref_plan, rc.SampleManager(ref_schema.tables, seed=0))
    got = port.execute(plan, pt.EstimationEngine(
        schema.tables, pt.SampleManager(schema.tables, seed=0), route))
    assert [k.label() for k in got] == [k.label() for k in want]
    for k, w in want.items():
        g = got[port_key(k)]
        assert (g.est_bytes, g.method, g.cost_pages, g.cf) == \
            (w.est_bytes, w.method, w.cost_pages, w.cf), k.label()
    for k, size in ex.items():
        assert got[k].est_bytes == size and got[k].method == "exact"


def test_sample_manager_add_table(schema):
    mgr = pt.SampleManager({}, seed=0)
    mgr.add_table(schema.tables["orders"])
    want = pt.SampleManager(schema.tables, seed=0).get_sample("orders", 0.05)
    got = mgr.get_sample("orders", 0.05)
    assert all(np.array_equal(got.values[c], want.values[c])
               for c in want.values)


# ---------------------------------------------------------------------------
# the walk with exact start nodes
# ---------------------------------------------------------------------------

def preset_by_hand(g, exact):
    """The same walk with the exact nodes' rows preset by hand: every
    child reference to an exact node is made to the pad (EXACT, RV (1,
    0), which is what the exact rows start as), a record on an exact
    target is dropped (an EXACT target is skipped), and an exact target's
    feasibility is read off the pad.  Returns the walk's result with the
    exact rows and the dropped records' codes filled in."""
    n = g.scost.shape[0] - 1
    ex = torch.zeros(n + 1, dtype=torch.bool)
    ex[exact.long()] = True
    child = torch.where(ex[g.child.long()], n, g.child.long()).int()
    keep = ~ex[g.tid.long()]
    off = g.cand_off.long()
    sel = torch.cat([torch.arange(int(off[r]), int(off[r + 1]))
                     for r in range(g.tid.numel()) if keep[r]] +
                    [torch.zeros(0, dtype=torch.long)])
    ncand = (off[1:] - off[:-1])[keep]
    new_off = torch.zeros(int(keep.sum()) + 1, dtype=torch.int32)
    new_off[1:] = torch.cumsum(ncand, 0)
    targets = torch.where(ex[g.targets.long()], n, g.targets.long()).int()
    h = dataclasses.replace(
        g, tid=g.tid[keep], kind=g.kind[keep], cand_off=new_off,
        child=child[sel], nchild=g.nchild[sel], dm=g.dm[sel], vt=g.vt[sel],
        mq=g.mq[sel], targets=targets, exact=None,
        max_cands=int(ncand.max()) if ncand.numel() else 0)
    res = ps.planner_walk_plain(h, E_, Q_)
    state = res.state.clone()
    state[ex] = ps.EXACT
    win = torch.full((g.tid.numel(), g.scost.shape[1]), ps.WALK_SKIP,
                     dtype=torch.int32)
    win[keep] = res.win
    return ps.WalkResult(state, res.mean, res.std, win, res.total, res.p,
                         res.feasible)


def exact_ids(g, seed, k):
    """k distinct node ids: some targets of records, some children."""
    r = np.random.default_rng(seed)
    tids = np.unique(g.tid.numpy())
    kids = np.unique(g.child.numpy()[g.child.numpy() < g.scost.shape[0] - 1])
    pick = np.unique(np.concatenate([r.choice(tids, k // 2, replace=False),
                                     r.choice(kids, k - k // 2,
                                              replace=False)]))
    return torch.as_tensor(pick, dtype=torch.int32)


@pytest.mark.parametrize("spec,k", [("ties", 2), ("synthetic", 40),
                                    ("synthetic-wide", 30)])
def test_walk_exact_equals_preset_by_hand(spec, k):
    if spec == "ties":
        g = walk_graph(WALK_TIES)
    elif spec == "synthetic":
        g = walk_graph(walk_synthetic(600, 120, 5, 3))
    else:
        g = walk_graph(walk_synthetic(12_000, 120, 5, 3, 300))
    ex = exact_ids(g, 7, k)
    got = ps.planner_walk(dataclasses.replace(g, exact=ex), E_, Q_)
    want = preset_by_hand(g, ex)
    for name, a, b in zip(ps.WalkResult._fields, got, want):
        assert torch.equal(a, b), name
    # an exact target's record is skipped and costs nothing
    on_exact = torch.isin(g.tid, ex)
    assert on_exact.any()
    assert bool((got.win[on_exact] == ps.WALK_SKIP).all())
    assert bool((got.state[ex.long()] == ps.EXACT).all())
    # and the walk without exact ids is another walk
    plain = ps.planner_walk(g, E_, Q_)
    assert not torch.equal(plain.state, got.state)


def test_walk_empty_exact_is_the_walk_without(schema):
    g = walk_graph(walk_synthetic(600, 120, 5, 3))
    a = ps.planner_walk(g, E_, Q_)
    b = ps.planner_walk(dataclasses.replace(
        g, exact=torch.zeros(0, dtype=torch.int32)), E_, Q_)
    for name, x, y in zip(ps.WalkResult._fields, a, b):
        assert torch.equal(x, y), name


def test_walk_rejects_bad_exact():
    g = walk_graph(WALK_TIES)
    with pytest.raises(ValueError, match="int32"):
        ps.planner_walk(dataclasses.replace(
            g, exact=torch.tensor([1], dtype=torch.int64)), E_, Q_)
    with pytest.raises(ValueError, match="inconsistent"):
        ps.planner_walk(dataclasses.replace(
            g, exact=torch.tensor([[1]], dtype=torch.int32)), E_, Q_)
    for bad in (-1, g.scost.shape[0]):
        with pytest.raises(ValueError, match="outside"):
            ps.planner_walk(dataclasses.replace(
                g, exact=torch.tensor([0, bad], dtype=torch.int32)), E_, Q_)


def test_engine_packs_exact_ids_and_walks_once(schema, monkeypatch):
    """The torch engine hands its exact ids to the walk, one walk a plan;
    a plan with `existing` never reuses a walk without it."""
    items = [(("lineitem", ("l_shipdate",), "NS"), 12345.0),
             (("lineitem", ("l_shipdate", "l_extendedprice"), "NS"), 99.0)]
    _, ex = existing_pair(items)
    tg = make_targets(NodeKey, "NS", 6)
    walks = []
    walk = ps.planner_walk

    def counting(g, *a, **kw):
        walks.append(g)
        return walk(g, *a, **kw)
    monkeypatch.setattr(ps, "planner_walk", counting)
    eng = PlannerEngine(schema.tables, ex, device=CPU, record=True)
    p1 = eng.plan_batch(tg, E_, Q_)
    p2 = eng.plan_batch(tg, E_, Q_)
    assert len(walks) == 1 and eng.replay_hits > 0
    ids = sorted(walks[0].exact.tolist())
    assert ids == sorted(eng._node_id[k] for k in ex)
    assert plan_summary(p1) == plan_summary(p2)
    bare = PlannerEngine(schema.tables, device=CPU, record=True)
    p0 = bare.plan_batch(tg, E_, Q_)
    assert walks[-1].exact.numel() == 0 and len(walks) == 2
    assert all(n.state is not State.EXACT for n in p0.nodes.values())
    assert p1.total_cost < p0.total_cost


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_universe_eviction_keeps_existing(schema, route):
    """An epoch eviction re-adds the existing indexes first: plans after it
    equal a fresh engine's."""
    items = [(("lineitem", ("l_shipdate",), "LDICT"), 12345.0)]
    _, ex = existing_pair(items)
    eng = PlannerEngine(schema.tables, ex, device=route, record=True,
                        max_nodes=4)
    a = make_targets(NodeKey, "LDICT", 6)
    b = make_targets(NodeKey, "LDICT", 4)
    for tg in (a, b, a):
        got = eng.plan_batch(tg, E_, Q_)
        fresh = PlannerEngine(schema.tables, ex, device=route).plan_batch(
            tg, E_, Q_)
        assert plan_summary(got) == plan_summary(fresh)
        assert next(iter(got.nodes)) == next(iter(ex))
    assert eng.universe_evictions >= 2
    assert eng._node_keys[0] == next(iter(ex))
