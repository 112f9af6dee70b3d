"""The Section 5.2 greedy as one walk per plan (`planner_walk`) against the
JAX package and against lines 6-11 computed directly in float64 NumPy.

On the CPU `planner_walk` runs its plain version, which scores each record
with `fused_score` and takes the greedy's decisions in float64.  Here:

* the engine's packing (`PlannerEngine._pack`) round-trips its `_Graph`,
  the EXACT pad row and duplicate targets included;
* the torch backend's plans (`plan`, `plan_all_sampled`) equal the JAX
  package's jax and numpy backends' on the TPC-H test schema: the same f,
  total cost, feasibility, node states and chosen deductions, and error
  RVs within the `fused_score` tolerances of
  test_torch_planner_score.py (mean rtol 1e-5; std rtol 1e-4, atol 1e-6),
  with one walk per plan;
* the walk's feasibility verdict (each target's p from its final RV in
  float32, every float64(p) >= q_feas) per fraction equals the JAX
  package's numpy and jax engines' `_feasible_vec` on the TPC-H test
  schema, under the plan's greedy and the all-sampled one (whose q_feas
  differs from the q it walks under);
* hand-built graphs pin where the greedy is float64: p >= q against the
  float64 q (trap a), the children's cost summed in float64 in child
  order (b), compared in float64 with the target's (c), the first argmin
  of that float64 sum (d), the total in record order without re-counting
  a child (e), SAMPLED nodes holding the float64 SampleCF RV (f), a
  duplicate target skipped (g); and ties (the first candidate wins), a
  child shared by two candidates, a child sampled by an earlier record.
  The reference takes each record's cm / cs / p from `fused_score`, the
  targets' p from `prob_within` and everything else from scalar float64
  NumPy; the walk must equal it exactly, on these graphs and on two
  random ones (600 and 12,000 nodes); a target whose p lands exactly on
  q_feas is feasible, one float64 step below it not.

test_torch_cuda_kernels.py holds the walk kernel bit-equal to this plain
version on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import workload as ref_wl
from repro.core.advisor import DesignAdvisor as RefAdvisor
from repro.core.estimation_graph import EstimationPlanner as RefPlanner
from repro_torch.core import errors as err
from repro_torch.core.compression import METHODS
from repro_torch.core.estimation_graph import F_GRID, EstimationPlanner, \
    NodeKey
from repro_torch.core.planner_engine import PlannerEngine
from repro_torch.kernels import launch_counts, planner_score as ps
from torch_port_util import (BIG, MID, TRAP_A_E, WALK_SUMS, WALK_SUMS_WIN,
                             WALK_TIES, WALK_TIES_WIN, WALK_TRAP_A,
                             assert_plans_match, port_schema, trap_a_score,
                             walk_graph, walk_synthetic)

E, Q = 0.5, 0.9
CPU = torch.device("cpu")


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


@pytest.fixture(scope="module")
def targets(ref_targets):
    return [NodeKey(k.table, k.cols, k.method) for k in ref_targets]


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def test_pack_round_trips_the_graph(schema, targets):
    eng = PlannerEngine(schema.tables, device=CPU)
    dup = targets + targets[:3]            # duplicates: one record each
    g = eng._build_graph(dup)
    n = len(g.node_keys)
    nf = len(F_GRID)
    scost = np.zeros((n + 1, nf))
    scost[:n] = eng._scost_matrix(g, F_GRID)
    samp = np.arange(4.0).reshape(2, 2) + 1.0
    wg, off, child = eng._pack(g, scost, samp, samp * 0.5, dup)
    assert len(g.recs) == len(dup) == wg.tid.numel()
    assert wg.tid.tolist() == [r.tid for r in g.recs]
    assert wg.kind.tolist() == [r.kind for r in g.recs]
    assert wg.cand_off.tolist() == off.tolist()
    assert torch.equal(wg.child, torch.as_tensor(child, dtype=torch.int32))
    assert wg.max_cands == max(len(r.cands) for r in g.recs)
    assert wg.targets.tolist() == [g.node_id[t] for t in dup]
    np.testing.assert_array_equal(wg.scost.numpy(), scost)
    assert (wg.scost[n] == 0).all()
    cs_dm, cs_msq, cs_vt = eng._cs_fac
    seen_dup = 0
    for i, rec in enumerate(g.recs):
        o = int(off[i])
        assert int(off[i + 1]) - o == len(rec.cands)
        for w in range(len(rec.cands)):
            row = wg.child[o + w].tolist()
            nch = rec.nchild[w]
            assert wg.nchild[o + w] == nch
            assert row[:nch] == rec.child_row(w)[:nch].tolist()
            assert row[nch:] == [n] * (len(row) - nch)     # the EXACT pad
            if w < rec.ncs:
                want = (cs_dm, cs_vt, cs_msq)
            else:
                x = w - rec.ncs
                want = (rec.cx_dm[x, 0], rec.cx_vterm[x, 0],
                        rec.cx_msq[x, 0])
            got = (wg.dm[o + w], wg.vt[o + w], wg.mq[o + w])
            assert [float(v) for v in got] == \
                [float(np.float32(v)) for v in want]
        seen_dup += rec.key in targets[:3]
    assert seen_dup >= 6


# ---------------------------------------------------------------------------
# the engine against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("all_sampled", [False, True])
@pytest.mark.parametrize("backend", ["jax", "numpy"])
def test_walk_plans_match_reference(ref_schema, schema, ref_targets,
                                    targets, monkeypatch, all_sampled,
                                    backend):
    walks = []
    walk = ps.planner_walk

    def counting(*a, **kw):
        walks.append(1)
        return walk(*a, **kw)
    monkeypatch.setattr(ps, "planner_walk", counting)
    ref = RefPlanner(ref_schema.tables, backend=backend, record=False)
    port = EstimationPlanner(schema.tables, device=CPU)
    before = launch_counts()
    if all_sampled:
        want = ref.plan_all_sampled(ref_targets, E, Q)
        got = port.plan_all_sampled(targets, E, Q)
    else:
        want = ref.plan(ref_targets, E, Q)
        got = port.plan(targets, E, Q)
    assert len(walks) == 1                   # one walk for the whole plan
    assert launch_counts() == before         # the CPU route launches nothing
    # SAMPLED nodes carry the exact float64 SampleCF RV on every backend
    ties = assert_plans_match(got, want, E, exact_rv=all_sampled)
    assert ties <= len(got.nodes) // 4


@pytest.mark.parametrize("q", [Q, 1.1])
def test_walk_equals_float64_reference_on_the_tpch_graph(schema, targets,
                                                         q):
    """The walk over the test schema's real graph (the plan's, and the
    all-sampled one's q) equals the float64 reference exactly."""
    eng = PlannerEngine(schema.tables, device=CPU)
    g = eng._build_graph(targets)
    n = len(g.node_keys)
    scost = np.zeros((n + 1, len(F_GRID)))
    scost[:n] = eng._scost_matrix(g, F_GRID)
    # the engine's SampleCF RV per order class (the last method of each)
    rep = {int(METHODS[m].order_dependent): m for m in METHODS}
    smean = np.array([[err.samplecf_error(rep[c], f).mean for f in F_GRID]
                      for c in (0, 1)])
    sstd = np.array([[err.samplecf_error(rep[c], f).std for f in F_GRID]
                     for c in (0, 1)])
    spec = {"n": n, "nf": len(F_GRID), "scost": scost[:n],
            "samp_mean": smean, "samp_std": sstd,
            "targets": [g.node_id[t] for t in targets],
            "recs": [(r.tid, r.kind,
                      [(r.child_row(w)[:r.nchild[w]].tolist(),
                        tuple(float(v) for v in (
                            (eng._cs_fac[0], eng._cs_fac[2], eng._cs_fac[1])
                            if w < r.ncs else
                            (r.cx_dm[w - r.ncs, 0], r.cx_vterm[w - r.ncs, 0],
                             r.cx_msq[w - r.ncs, 0]))))
                       for w in range(len(r.cands))])
                     for r in g.recs]}
    wg, _, _ = eng._pack(g, scost, smean, sstd, targets)
    got = ps.planner_walk(wg, E, q)
    assert_walk_equals(got, reference_walk(spec, E, q))
    assert (got.win >= 0).any() or q > 1      # deductions were taken


@pytest.mark.parametrize("e,q", [(0.5, 0.9), (0.2, 0.9), (0.1, 0.9)],
                         ids=["all feasible", "mixed", "none feasible"])
@pytest.mark.parametrize("all_sampled", [False, True])
@pytest.mark.parametrize("backend", ["jax", "numpy"])
def test_walk_feasibility_matches_reference(ref_schema, schema, ref_targets,
                                            targets, e, q, all_sampled,
                                            backend):
    """The per-fraction feasibility the walk judges (under FORCE_ALL_Q for
    the "All" baseline, against the caller's q) equals the JAX package's
    engines' and the port's own host route's."""
    from repro.core.estimation_graph import FORCE_ALL_Q as REF_FORCE
    from repro.core.planner_engine import PlannerEngine as RefEngine
    from repro_torch.core.estimation_graph import FORCE_ALL_Q
    ref = RefEngine(ref_schema.tables, backend=backend, record=False)
    st = ref._run(ref_targets, e, REF_FORCE if all_sampled else q, F_GRID)
    want = ref._feasible_vec(st, e, q)
    eng = PlannerEngine(schema.tables, device=CPU)
    got = eng._run(targets, e, FORCE_ALL_Q if all_sampled else q, q_feas=q)
    assert got.feasible is not None            # the walk's own verdict
    np.testing.assert_array_equal(got.feasible, want)
    host = PlannerEngine(schema.tables)
    np.testing.assert_array_equal(
        host._feasible_vec(host._run(targets, e, FORCE_ALL_Q if all_sampled
                                     else q), e, q), want)


def test_numpy_backend_does_not_walk(schema, targets, monkeypatch):
    def fail(*a, **kw):
        raise AssertionError("the numpy backend walked")
    monkeypatch.setattr(ps, "planner_walk", fail)
    EstimationPlanner(schema.tables).plan(targets, E, Q)


# ---------------------------------------------------------------------------
# hand-built graphs: lines 6-11 in float64 NumPy
# ---------------------------------------------------------------------------

def reference_walk(spec, e, q, q_feas=None):
    """Each record's cm / cs / p from `fused_score` on its stacked
    children; the decisions, sums and states in scalar float64 NumPy, one
    fraction at a time; then each target's p from `prob_within` on its
    final RV rounded to float32, and feasible where every float64(p) >=
    q_feas (q by default)."""
    n, nf, recs = spec["n"], spec["nf"], spec["recs"]
    k = max([1] + [len(ch) for _, _, cands in recs for ch, _ in cands])
    scost = np.zeros((n + 1, nf))
    scost[:n] = spec["scost"]
    smean = np.asarray(spec["samp_mean"], dtype=np.float64)
    sstd = np.asarray(spec["samp_std"], dtype=np.float64)
    state = np.zeros((n + 1, nf), dtype=np.uint8)
    state[n] = ps.EXACT
    mean = np.ones((n + 1, nf))
    std = np.zeros((n + 1, nf))
    total = np.zeros(nf)
    win = np.zeros((len(recs), nf), dtype=np.int32)
    for r, (t, kc, cands) in enumerate(recs):
        nc = len(cands)
        if nc:
            ids = np.full((nc, k), n)
            for c, (ch, _) in enumerate(cands):
                ids[c, :len(ch)] = ch
            known = state[ids] != ps.NONE
            m = np.where(known, mean[ids], smean[kc]).astype(np.float32)
            s = np.where(known, std[ids], sstd[kc]).astype(np.float32)
            fac = np.array([f for _, f in cands], dtype=np.float32)
            cm, cs, p, _, _ = ps.fused_score(
                torch.from_numpy(m), torch.from_numpy(s),
                *(torch.from_numpy(fac[:, i].copy()) for i in range(3)),
                torch.ones((nc, nf), dtype=torch.bool), None, None, e, q)
            cm, cs, p = cm.numpy(), cs.numpy(), p.numpy()
        for f in range(nf):
            if state[t, f] != ps.NONE:
                win[r, f] = ps.WALK_SKIP
                continue
            allk, extra = [], []
            for ch, _ in cands:
                allk.append(all(state[x, f] != ps.NONE for x in ch))
                x_sum = 0.0
                for x in ch:                        # child order, float64
                    if state[x, f] == ps.NONE:
                        x_sum += float(scost[x, f])
                extra.append(x_sum)
            sat = [float(p[c, f]) >= q for c in range(nc)]
            w6 = None
            for c in range(nc):                     # first argmax of p
                if allk[c] and sat[c] and (w6 is None or p[c, f] > p[w6, f]):
                    w6 = c
            w9 = None
            if w6 is None:
                for c in range(nc):                 # first argmin of extra
                    if not allk[c] and extra[c] < scost[t, f] and sat[c] \
                            and (w9 is None or extra[c] < extra[w9]):
                        w9 = c
            if w6 is not None or w9 is not None:
                w = w6 if w6 is not None else w9
                if w9 is not None:
                    for x in cands[w][0]:
                        if state[x, f] == ps.NONE:
                            state[x, f] = ps.SAMPLED
                            mean[x, f], std[x, f] = smean[kc, f], sstd[kc, f]
                            total[f] += scost[x, f]
                state[t, f] = ps.DEDUCED
                mean[t, f], std[t, f] = float(cm[w, f]), float(cs[w, f])
                win[r, f] = w if w6 is not None else ps.WALK_LINE9 + w
            else:                                   # lines 10-11
                state[t, f] = ps.SAMPLED
                mean[t, f], std[t, f] = smean[kc, f], sstd[kc, f]
                total[f] += scost[t, f]
                win[r, f] = ps.WALK_FALLBACK
    tg = spec.get("targets", [r[0] for r in recs])
    p = ps.prob_within(torch.from_numpy(mean[tg].astype(np.float32)),
                       torch.from_numpy(std[tg].astype(np.float32)),
                       e).numpy().reshape(len(tg), nf)
    q_feas = q if q_feas is None else q_feas
    feasible = np.array([all(float(v) >= q_feas for v in p[:, f])
                         for f in range(nf)])
    return state, mean, std, win, total, p, feasible


def assert_walk_equals(got, want):
    assert len(got) == len(want) == len(ps.WalkResult._fields)
    for name, a, b in zip(ps.WalkResult._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


# random graphs (walk_synthetic's arguments): 600 nodes, and 12,000 nodes
# of which 300 are used (on the card the walk keeps this graph's node
# state in global memory)
WALK_SYNTH = {"synthetic": (600, 120, 5, 3),
              "synthetic-wide": (12_000, 120, 5, 3, 300)}


@pytest.mark.parametrize("spec", [WALK_SUMS, WALK_TIES, *WALK_SYNTH],
                         ids=["float64-sums", "ties", *WALK_SYNTH])
def test_walk_equals_float64_reference(spec):
    if isinstance(spec, str):
        spec = walk_synthetic(*WALK_SYNTH[spec])
    got = ps.planner_walk(walk_graph(spec), E, Q)
    assert_walk_equals(got, reference_walk(spec, E, Q))
    if spec["n"] > 100:      # a random graph reaches every decision kind
        w = got.win
        assert min(int((w == ps.WALK_SKIP).sum()),
                   int((w == ps.WALK_FALLBACK).sum()),
                   int(((w >= 0) & (w < ps.WALK_LINE9)).sum()),
                   int((w >= ps.WALK_LINE9).sum())) > 0


def test_walk_float64_sums_and_order():
    """Traps b-g on WALK_SUMS, each with the decision a float32 or
    reordered greedy would get wrong."""
    got = ps.planner_walk(walk_graph(WALK_SUMS), E, Q)
    assert got.win.tolist() == WALK_SUMS_WIN
    # (e) children 0, 1, 2 (2^53, 1, 1), then child 8 (2^24 + 3), then
    # the fallback target 7 (1): float64 in this order; child 0 is not
    # counted again when record 3 deduces from it
    total = 0.0
    for c in (BIG, 1.0, 1.0, MID + 3, MID + 0.5, 1.0):
        total += c
    assert got.total.tolist() == [total]
    # (f) a SAMPLED node holds the float64 SampleCF RV, not its float32
    assert got.state[0, 0] == ps.SAMPLED
    assert got.mean[0, 0] == 1.0 + 1e-9 and got.std[0, 0] == 0.01
    assert got.state[7, 0] == ps.SAMPLED and got.mean[7, 0] == 1.0 - 1e-9
    # a DEDUCED node holds float32 values
    assert got.state[11, 0] == ps.DEDUCED
    assert got.mean[11, 0] == float(np.float32(got.mean[11, 0]))


def test_walk_ties_and_shared_children():
    got = ps.planner_walk(walk_graph(WALK_TIES), E, Q)
    # record 0: tied extra (candidates 0 and 1, the same children), the
    # first wins; fraction 1's costs forbid lines 8-9 and fraction 2's
    # SampleCF error is too wide.  Record 1: child 3 shared by both
    # candidates, children 0 and 1 sampled by record 0 (fraction 0) or
    # not (1): tied extra, the first.  Record 3 repeats target 4: skipped.
    # Record 5: tied p on an all-known child, the first
    assert got.win.tolist() == WALK_TIES_WIN


@pytest.mark.parametrize("above", [False, True])
def test_walk_compares_p_with_float64_q(above):
    """(a) q one float64 step above float64(p), so float32(q) == p: the
    float64 comparison fails where a float32 one would pass."""
    p = trap_a_score()
    q = float(np.nextafter(np.float64(p), 2.0)) if above else p
    assert float(np.float32(q)) == p
    got = ps.planner_walk(walk_graph(WALK_TRAP_A), TRAP_A_E, q)
    want = reference_walk(WALK_TRAP_A, TRAP_A_E, q)
    assert_walk_equals(got, want)
    assert int(got.win[1, 0]) == (ps.WALK_FALLBACK if above else 0)


@pytest.mark.parametrize("spec", [WALK_SUMS, WALK_TIES, WALK_TRAP_A],
                         ids=["float64-sums", "ties", "trap-a"])
@pytest.mark.parametrize("q_feas", [None, 0.5, 0.99])
def test_walk_feasibility_on_hand_graphs(spec, q_feas):
    """p and feasible against the reference, q_feas = q and apart from
    it, with each graph's targets and with its first and last alone."""
    e = TRAP_A_E if spec is WALK_TRAP_A else E
    for tg in (None, [spec["recs"][0][0], spec["recs"][-1][0]]):
        sp = spec if tg is None else {**spec, "targets": tg}
        got = ps.planner_walk(walk_graph(sp), e, Q, q_feas)
        assert_walk_equals(got, reference_walk(sp, e, Q, q_feas))
        assert got.p.shape == (len(sp.get("targets", sp["recs"])),
                               sp["nf"])


@pytest.mark.parametrize("step", [-1, 0, 1])
def test_walk_feasibility_where_p_lands_on_q(step):
    """Trap a's node 1, deduced at the trap's q with p its candidate's
    score: feasible against q_feas = p and the float64 below it, not
    against the float64 above; judged apart from the greedy's q."""
    p = trap_a_score()
    q_feas = float(np.nextafter(np.float64(p), 2.0 * step)) if step else p
    sp = {**WALK_TRAP_A, "targets": [1]}
    got = ps.planner_walk(walk_graph(sp), TRAP_A_E, p, q_feas)
    assert int(got.win[1, 0]) == 0 and float(got.p[0, 0]) == p
    assert got.feasible.tolist() == [step <= 0]
    assert_walk_equals(got, reference_walk(sp, TRAP_A_E, p, q_feas))


def test_walk_without_targets_is_feasible():
    got = ps.planner_walk(walk_graph({**WALK_TIES, "targets": []}), E, Q)
    assert got.p.shape == (0, WALK_TIES["nf"])
    assert got.feasible.tolist() == [True] * WALK_TIES["nf"]


def test_walk_rejects_bad_inputs():
    g = walk_graph(WALK_TIES)
    with pytest.raises(ValueError, match="float32"):
        ps.planner_walk(dataclasses.replace(g, dm=g.dm.double()), E, Q)
    with pytest.raises(ValueError, match="inconsistent"):
        ps.planner_walk(dataclasses.replace(g, kind=g.kind[:-1]), E, Q)
    with pytest.raises(ValueError, match="int32"):
        ps.planner_walk(dataclasses.replace(g, targets=g.targets.long()), E,
                        Q)
    with pytest.raises(ValueError, match="inconsistent"):
        ps.planner_walk(dataclasses.replace(g, targets=g.targets[:, None]),
                        E, Q)
