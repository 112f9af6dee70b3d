"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here is marked `cuda` and skips on a host without a CUDA card;
this file imports only `repro_torch` (no JAX), so it also runs on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the five codec kernels bit-equal (integers); `prob_within` and
`fused_score` p within atol 1e-6 and cm / cs within rtol 1e-6 (the same
IEEE float ops; only CUDA's erff and PyTorch's erf may differ by an ulp);
winners equal; prob consistency bitwise; the planner walk bit-equal to
its plain version (which scores each record with the fused_score kernel)
on hand-built graphs, random graphs in both of its state layouts and the
TPC-H scale=1 graph, launched once per plan, also with exact start
ids (existing indexes) in both layouts.  Blockwise quantization bit-equal
(q and scales: the same IEEE divisions and round-half-even);
dequant-matmul within rtol and atol 1e-4 of the plain version's IEEE
float32 product (another summation order; the tensor-core route's a in
two bf16 terms), on both of its kernels, bit-equal from call to call.
Blockwise dequantization bit-equal in float32 and bfloat16 (one rounded
multiply, a round-to-nearest-even cast), single and grouped; the grouped
quantize bit-equal in one launch per `group_capacity()` items, on
unaligned views, bfloat16 inputs, other blocks and .5 boundaries.  LDICT's
shared-memory hash set and the warp and block paths of PREFIX and RLE
bit-equal on their edge cases (page sizes on both sides of the warp /
block split, INT64_MIN and INT64_MAX, pages that mix signs, runs across
page, pair and warp-step boundaries, more than 65,535 pages); NS on its
significant-byte edges with rows of one block and rows split over a
cluster of blocks (the edge inputs of `torch_port_util`, which
test_torch_codec_page_edges.py holds to the JAX package on the CPU).
GDICT's hash set bit-equal on its edge rows in each of its three layouts
(a block's shared memory, a cluster's, global memory), one launch a call
and no sort; the walk's feasibility (p and feasible) bit-equal to
`prob_within` on the walk's own final RVs and to the plain walk.  An
online `AdvisorSession` on the card recommends `==` a fresh cuda
`DesignAdvisor` after each round, with one walk per re-planned round and
no launch on a reweight-only round; a fleet of three tenants on the card
recommends `==` fresh cuda runs, and its stacked cost phase is bit-equal
to per-job costing on the card.  A q8 checkpoint written from the card is
byte-identical to its CPU copy's, and its restore on the card equals the
plain dequantize of the plain quantize.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import compression as comp
from repro_torch.kernels import codec_bytes as cb, launch_counts
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import planner_score as ps
from repro_torch.kernels import quantize_blockwise as qb
from torch_port_util import (GDICT_EDGE_NS, PAGE_EDGE_RPPS, TRAP_A_E,
                             WALK_SUMS, WALK_SUMS_WIN, WALK_TIES,
                             WALK_TIES_WIN, WALK_TRAP_A, gdict_edge_stack,
                             ns_edge_stack, page_edge_n, run_edge_stack,
                             trap_a_score, walk_graph, walk_synthetic)

E = 0.1


def f32(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def random_rvs(nc, k, nf, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.85, 1.15, size=(nc, k, nf))
    s = rng.uniform(0.0, 0.08, size=(nc, k, nf))
    dm = rng.uniform(0.95, 1.05, size=(nc, 1))
    ds = rng.uniform(0.0, 0.05, size=(nc, 1))
    return m, s, dm, ds * ds + dm * dm, dm * dm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CODEC_SHAPES = [
    ((126, 6000), 273, 1 << 32), ((1, 5000), 1638, 1 << 60),
    ((5, 1), 273, 256), ((3, 777), 1, 1 << 16), ((9, 1000), 1638, 1 << 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rpp,top", CODEC_SHAPES)
def test_cuda_kernels_equal_plain(cuda, shape, rpp, top):
    rng = np.random.default_rng(shape[1])
    cols = torch.as_tensor(rng.integers(-top, top, size=shape), device=cuda)
    widths = torch.as_tensor(rng.integers(1, 9, size=shape[0]), device=cuda)
    before = launch_counts()
    assert torch.equal(cb.ns_bytes(cols, widths),
                       cb.ns_bytes_plain(cols, widths))
    assert torch.equal(cb.ldict_bytes(cols, widths, rpp),
                       cb.ldict_bytes_plain(cols, widths, rpp))
    after = launch_counts()
    assert after["ns_bytes"] == before["ns_bytes"] + 1
    assert after["ldict_bytes"] == before["ldict_bytes"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rpp,top", CODEC_SHAPES)
def test_cuda_gdict_prefix_rle_equal_plain(cuda, shape, rpp, top):
    rng = np.random.default_rng(shape[1])
    cols = torch.as_tensor(rng.integers(-top, top, size=shape), device=cuda)
    if shape[0] > 2:
        cols[1] = 7                                  # one run, one value
        cols[2] = torch.sort(cols[2]).values         # sorted, mixed signs
    widths = torch.as_tensor(rng.integers(1, 9, size=shape[0]), device=cuda)
    before = launch_counts()
    assert torch.equal(cb.gdict_bytes(cols, widths),
                       cb.gdict_bytes_plain(cols, widths))
    assert torch.equal(cb.prefix_bytes(cols, widths, rpp),
                       cb.prefix_bytes_plain(cols, widths, rpp))
    assert torch.equal(cb.rle_bytes(cols, widths, rpp),
                       cb.rle_bytes_plain(cols, widths, rpp))
    after = launch_counts()
    for name in ("gdict_bytes", "prefix_bytes", "rle_bytes"):
        assert after[name] == before[name] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("method", ("NS", "GDICT", "LDICT", "PREFIX", "RLE"))
def test_cuda_batched_bytes_launches_a_kernel(cuda, method):
    rng = np.random.default_rng(1)
    cols = torch.as_tensor(rng.integers(0, 1 << 20, size=(4, 3000)),
                           device=cuda)
    widths = torch.as_tensor([1, 3, 4, 8], device=cuda)
    before = sum(launch_counts().values())
    got = comp.batched_bytes(method, cols, widths, 273, backend="torch")
    assert sum(launch_counts().values()) == before + 1
    want = comp.batched_bytes(method, cols.cpu().numpy(),
                              widths.cpu().numpy(), 273)
    assert got.cpu().tolist() == want.tolist()


@pytest.mark.cuda
def test_cuda_prob_within_close_to_plain(cuda):
    rng = np.random.default_rng(0)
    means = f32(np.r_[rng.uniform(0.3, 2.5, 3000), [1.0, 0.2]], cuda)
    stds = f32(np.r_[rng.uniform(0.0, 0.8, 3000), [0.0, 0.0]], cuda)
    got = ps.prob_within(means, stds, E)
    want = ps.prob_within_plain(means, stds, E)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("nc,k,nf", [(14, 11, 5), (1, 1, 5), (300, 3, 5)])
def test_cuda_fused_score_close_to_plain(cuda, nc, k, nf):
    m, s, dm, vt, mq = random_rvs(nc, k, nf, seed=nc)
    rng = np.random.default_rng(k)
    mask67 = torch.as_tensor(rng.random((nc, nf)) < 0.5, device=cuda)
    pre9 = ~mask67 & torch.as_tensor(rng.random((nc, nf)) < 0.5,
                                     device=cuda)
    args = (f32(m, cuda), f32(s, cuda), f32(dm.ravel(), cuda),
            f32(vt.ravel(), cuda), f32(mq.ravel(), cuda), mask67, pre9,
            f32(rng.uniform(1, 9, (nc, nf)), cuda))
    got = ps.fused_score(*args, E, 0.3)
    want = ps.fused_score_plain(*args, E, 0.3)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0.0)
    assert float((got[2] - want[2]).abs().max()) <= 1e-6
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    again = ps.prob_within(got[0], got[1], E)
    mask = mask67 | pre9
    assert torch.equal(got[2][mask], again[mask])


def walk_bit_equal(got, want):
    for name, a, b in zip(ps.WalkResult._fields, got, want):
        if a.dtype == torch.float64:
            a, b = a.contiguous().view(torch.int64), b.contiguous().view(
                torch.int64)
        assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def tpch_targets():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import core as pt
    schema = pt.make_tpch_like(scale=1.0, z=0.0, seed=0)
    adv = pt.DesignAdvisor(pt.make_tpch_workload(schema, insert_weight=0.1),
                           pt.AdvisorOptions(backend="numpy"))
    return schema, list(adv.estimation_targets(adv._candidate_universe()[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sums", "ties", "trap-a", "trap-a-above"])
def test_cuda_planner_walk_equals_plain_on_hand_graphs(cuda, name):
    spec, e, q = {"sums": (WALK_SUMS, 0.5, 0.9),
                  "ties": (WALK_TIES, 0.5, 0.9)}.get(name, (WALK_TRAP_A,
                                                            TRAP_A_E, None))
    if q is None:            # p of the trap's candidate, scored on the card
        p = trap_a_score(cuda)
        q = float(np.nextafter(np.float64(p), 2.0)) if name.endswith(
            "above") else p
    g = walk_graph(spec, cuda)
    before = launch_counts()
    got = ps.planner_walk(g, e, q)
    assert launch_counts()["planner_walk"] == before["planner_walk"] + 1
    want = ps.planner_walk_plain(g, e, q)
    walk_bit_equal(got, want)
    if spec is WALK_SUMS:
        assert got.win.tolist() == WALK_SUMS_WIN
    elif spec is WALK_TIES:
        assert got.win.tolist() == WALK_TIES_WIN
    else:
        assert int(got.win[1, 0]) == (ps.WALK_FALLBACK if name.endswith(
            "above") else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n, in_smem", [(600, True), (12_000, False)])
def test_cuda_planner_walk_equals_plain_in_both_state_layouts(cuda, n,
                                                              in_smem):
    """The walk's node state in shared memory (600 nodes) and in global
    memory (12,000 nodes, beyond what a block may opt into), each
    bit-equal to the plain walk on the card; 600 of the nodes are used."""
    g = walk_graph(walk_synthetic(n, 450, 5, 3, used=600), cuda)
    assert ps.walk_in_shared_memory(g) is in_smem
    before = launch_counts()
    got = ps.planner_walk(g, 0.5, 0.9)
    assert launch_counts()["planner_walk"] == before["planner_walk"] + 1
    walk_bit_equal(got, ps.planner_walk_plain(g, 0.5, 0.9))
    assert int((got.win >= ps.WALK_LINE9).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n, in_smem", [(600, True), (12_000, False)])
def test_cuda_planner_walk_with_exact_ids_equals_plain(cuda, n, in_smem):
    """Existing indexes (§5.1): the walk with exact start ids, some of
    them record targets and some children, bit-equal to the plain walk
    in both state layouts; their rows EXACT (1, 0) and their records
    skipped."""
    g = walk_graph(walk_synthetic(n, 450, 5, 3, used=600), cuda)
    assert ps.walk_in_shared_memory(g) is in_smem
    r = np.random.default_rng(11)
    tids = np.unique(g.tid.cpu().numpy())
    kids = np.unique(g.child.cpu().numpy())
    kids = kids[kids < n]
    ex = np.unique(np.concatenate([r.choice(tids, 20, replace=False),
                                   r.choice(kids, 40, replace=False)]))
    g = dataclasses.replace(g, exact=torch.as_tensor(
        ex, dtype=torch.int32, device=cuda))
    before = launch_counts()
    got = ps.planner_walk(g, 0.5, 0.9)
    assert launch_counts()["planner_walk"] == before["planner_walk"] + 1
    walk_bit_equal(got, ps.planner_walk_plain(g, 0.5, 0.9))
    exl = g.exact.long()
    assert bool((got.state[exl] == ps.EXACT).all())
    assert bool((got.mean[exl] == 1.0).all() and (got.std[exl] == 0.0).all())
    assert bool((got.win[torch.isin(g.tid, g.exact)] == ps.WALK_SKIP).all())


@pytest.mark.cuda
@pytest.mark.parametrize("q", [0.9, 1.1])
def test_cuda_planner_walk_equals_plain_on_the_tpch_graph(cuda, tpch_targets,
                                                         q):
    """The walk kernel bit-equal to its plain version (the per-record
    fused_score kernel and float64 decisions) on the scale=1 graph."""
    from repro_torch.core import planner_engine as pe
    schema, targets = tpch_targets
    eng = pe.PlannerEngine(schema.tables, device=cuda)
    wgs = []
    walk = ps.planner_walk
    try:
        ps.planner_walk = lambda g, *a: wgs.append(g) or walk(g, *a)
        eng.plan_batch(targets, 0.5, q)
    finally:
        ps.planner_walk = walk
    assert len(wgs) == 1
    walk_bit_equal(ps.planner_walk(wgs[0], 0.5, q),
                   ps.planner_walk_plain(wgs[0], 0.5, q))


@pytest.mark.cuda
@pytest.mark.parametrize("all_sampled", [False, True])
def test_cuda_planner_one_walk_launch_per_plan(cuda, tpch_targets,
                                              all_sampled):
    """The torch backend's planner launches planner_walk once per plan and
    the per-record fused_score not at all."""
    from repro_torch.core.estimation_graph import EstimationPlanner
    schema, targets = tpch_targets
    planner = EstimationPlanner(schema.tables, device=cuda)
    before = launch_counts()
    if all_sampled:
        planner.plan_all_sampled(targets, 0.5, 0.9)
    else:
        planner.plan(targets, 0.5, 0.9)
    after = launch_counts()
    assert after["planner_walk"] == before["planner_walk"] + 1
    assert after["fused_score"] == before["fused_score"]
    assert after["prob_within"] == before["prob_within"]


@pytest.mark.cuda
@pytest.mark.parametrize("n, in_smem", [(600, True), (12_000, False)])
@pytest.mark.parametrize("q_feas", [None, 0.3, 0.95])
def test_cuda_planner_walk_feasibility_equals_prob_within(cuda, n, in_smem,
                                                          q_feas):
    """The walk's p is prob_within's on the walk's own final (mean, std)
    of the targets, rounded to float32; feasible is every float64(p) >=
    q_feas; both bit-equal to the plain walk, in both state layouts."""
    spec = walk_synthetic(n, 450, 5, 3, used=600)
    spec["targets"] = [r[0] for r in spec["recs"][::3]] + [n - 1]
    g = walk_graph(spec, cuda)
    assert ps.walk_in_shared_memory(g) is in_smem
    got = ps.planner_walk(g, 0.5, 0.9, q_feas)
    walk_bit_equal(got, ps.planner_walk_plain(g, 0.5, 0.9, q_feas))
    tg = g.targets.long()
    again = ps.prob_within(got.mean[tg].float(), got.std[tg].float(), 0.5)
    assert torch.equal(got.p.view(torch.int32), again.view(torch.int32))
    q = 0.9 if q_feas is None else q_feas
    assert torch.equal(got.feasible, (got.p.double() >= q).all(dim=0))


I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def ldict_stack(n, seed):
    """Rows that stress a distinct count: all equal, all distinct, the
    int64 extremes (INT64_MIN is the kernel's empty-slot marker), values
    that differ only in their high bits, a small domain, the full range."""
    rng = np.random.default_rng(seed)
    rows = [np.full(n, 5), np.arange(n) * 7 - n]
    ext = rng.choice([I64_MIN, I64_MAX, 0, -1, 1], size=n)
    ext[0], ext[-1] = I64_MIN, I64_MAX
    rows += [ext, np.full(n, I64_MIN), np.full(n, I64_MAX),
             rng.integers(0, 256, size=n) << 55,
             rng.integers(0, 5, size=n),
             rng.integers(I64_MIN, I64_MAX, size=n, endpoint=True)]
    return np.stack(rows).astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("rpp", [1, 31, 32, 33, 273, 512, 513, 1638])
@pytest.mark.parametrize("pages", ["ragged", "n < rpp"])
@pytest.mark.parametrize("copies", [1, 256], ids=["few pages", "many pages"])
def test_cuda_ldict_edge_cases_equal_plain(cuda, rpp, pages, copies):
    """Few pages take the kernel's block-per-page path, >= 1,024 pages of
    <= 512 rows its warp-per-page path: the edge rows go through both."""
    n = 3 * rpp + rpp // 2 + 1 if pages == "ragged" else max(1, rpp - 3)
    cols = torch.as_tensor(np.tile(ldict_stack(n, rpp), (copies, 1)),
                           device=cuda)
    widths = torch.as_tensor([1, 2, 8, 8, 8, 8, 1, 8] * copies, device=cuda)
    before = launch_counts()["ldict_bytes"]
    got = cb.ldict_bytes(cols, widths, rpp)
    want = cb.ldict_bytes_plain(cols, widths, rpp)
    torch.cuda.synchronize()
    assert launch_counts()["ldict_bytes"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rpp", [1, 31, 32, 33, 273, 512, 513, 4096])
@pytest.mark.parametrize("pages", ["ragged", "n < rpp"])
@pytest.mark.parametrize("copies", [1, 256], ids=["few pages", "many pages"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "row offset"])
def test_cuda_prefix_edge_cases_equal_plain(cuda, rpp, pages, copies,
                                            offset):
    """Few pages, or pages of more than 512 rows, take PREFIX's
    block-per-page path, >= 1,024 pages of <= 512 rows its warp path: the
    int64 extremes, pages that mix signs and values differing only in
    their high bits go through both, with pages starting 16-byte aligned
    or not (a stack that starts one row later)."""
    n = 3 * rpp + rpp // 2 + 1 if pages == "ragged" else max(1, rpp - 3)
    stack = np.tile(ldict_stack(n, rpp + 1), (copies, 1))
    cols = torch.as_tensor(stack, device=cuda)[offset:]
    widths = torch.as_tensor([1, 2, 8, 8, 8, 8, 1, 8] * copies,
                             device=cuda)[offset:]
    before = launch_counts()["prefix_bytes"]
    got = cb.prefix_bytes(cols, widths, rpp)
    want = cb.prefix_bytes_plain(cols, widths, rpp)
    torch.cuda.synchronize()
    assert launch_counts()["prefix_bytes"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rpp", [((1, 65535), 1), ((65535, 3), 3),
                                       ((240, 75000), 273),
                                       ((801, 60000), 273),
                                       ((1639, 1638 * 40), 1638)])
def test_cuda_prefix_over_65535_pages_equal_plain(cuda, shape, rpp):
    rng = np.random.default_rng(shape[1] + 1)
    top = 1 << int(rng.integers(1, 62))
    cols = torch.as_tensor(rng.integers(-top, top, size=shape), device=cuda)
    widths = torch.as_tensor(rng.integers(1, 9, size=shape[0]), device=cuda)
    assert shape[0] * -(-shape[1] // rpp) >= 65535
    assert torch.equal(cb.prefix_bytes(cols, widths, rpp),
                       cb.prefix_bytes_plain(cols, widths, rpp))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rpp", [((1, 65535), 1), ((65535, 3), 3),
                                       ((240, 75000), 273),
                                       ((1639, 1638 * 40), 1638)])
def test_cuda_ldict_over_65535_pages_equal_plain(cuda, shape, rpp):
    rng = np.random.default_rng(shape[1])
    cols = torch.as_tensor(rng.integers(0, 1 << rng.integers(1, 40),
                                        size=shape), device=cuda)
    widths = torch.as_tensor(rng.integers(1, 9, size=shape[0]), device=cuda)
    assert shape[0] * -(-shape[1] // rpp) >= 65535
    assert torch.equal(cb.ldict_bytes(cols, widths, rpp),
                       cb.ldict_bytes_plain(cols, widths, rpp))


@pytest.mark.cuda
@pytest.mark.parametrize("rpp", PAGE_EDGE_RPPS)
@pytest.mark.parametrize("pages", ["ragged", "n < rpp"])
@pytest.mark.parametrize("copies", [1, 256], ids=["few pages", "many pages"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "row offset"])
def test_cuda_rle_edge_cases_equal_plain(cuda, rpp, pages, copies, offset):
    """RLE (and PREFIX, which walks pages the same way) on runs across
    page, 16-byte pair and warp-step boundaries, the int64 extremes and
    top-bit-only differences: few pages, or pages of more than 512 rows,
    take the block per page, >= 1,024 pages of <= 512 rows the warp path;
    pages start 16-byte aligned or not (a stack that starts one row
    later)."""
    cols, widths = run_edge_stack(page_edge_n(rpp, pages), rpp, rpp + 1,
                                  signed=True)
    cols = torch.as_tensor(np.tile(cols, (copies, 1)), device=cuda)[offset:]
    widths = torch.as_tensor(np.tile(widths, copies), device=cuda)[offset:]
    before = launch_counts()
    got = cb.rle_bytes(cols, widths, rpp)
    got_px = cb.prefix_bytes(cols, widths, rpp)
    want = cb.rle_bytes_plain(cols, widths, rpp)
    want_px = cb.prefix_bytes_plain(cols, widths, rpp)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["rle_bytes"] == before["rle_bytes"] + 1
    assert after["prefix_bytes"] == before["prefix_bytes"] + 1
    assert torch.equal(got, want)
    assert torch.equal(got_px, want_px)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rpp", [((1, 65535), 1), ((65535, 3), 3),
                                       ((240, 75000), 273),
                                       ((801, 60000), 273),
                                       ((1639, 1638 * 40), 1638)])
def test_cuda_rle_over_65535_pages_equal_plain(cuda, shape, rpp):
    """Runs of 1-4 equal values of both signs on more than 65,535 pages."""
    rng = np.random.default_rng(shape[1] + 2)
    vals = rng.integers(-(1 << 40), 1 << 40, size=shape)
    cols = np.repeat(vals, rng.integers(1, 5, size=shape[1]),
                     axis=1)[:, :shape[1]]
    cols = torch.as_tensor(np.ascontiguousarray(cols), device=cuda)
    widths = torch.as_tensor(rng.integers(1, 9, size=shape[0]), device=cuda)
    assert shape[0] * -(-shape[1] // rpp) >= 65535
    assert torch.equal(cb.rle_bytes(cols, widths, rpp),
                       cb.rle_bytes_plain(cols, widths, rpp))


NS_CARD_CASES = [(m, n) for m in (1, 11, 200, 4096)
                 for n in (1, 7, 60000, 60001, (1 << 20) + 3)
                 if m * n <= 1 << 24] + [(4096, 4097)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", NS_CARD_CASES)
def test_cuda_ns_edge_cases_equal_plain(cuda, m, n):
    """NS's significant-byte edges (INT64_MIN and INT64_MAX among them) at
    every width, with a row offset (rows not 16-byte aligned where n is
    odd), one launch per call: rows of one block, and rows split over a
    cluster of up to 8 blocks."""
    stack, widths = ns_edge_stack(n, signed=True)
    reps = -(-(m + 1) // len(stack))
    cols = torch.as_tensor(np.tile(stack, (reps, 1))[:m + 1],
                           device=cuda)[1:]
    widths = torch.as_tensor(np.tile(widths, reps)[:m + 1], device=cuda)[1:]
    before = launch_counts()["ns_bytes"]
    got = cb.ns_bytes(cols, widths)
    want = cb.ns_bytes_plain(cols, widths)
    torch.cuda.synchronize()
    assert launch_counts()["ns_bytes"] == before + 1
    assert torch.equal(got, want)


def quantize_cases():
    rng = np.random.default_rng(7)
    half = np.zeros((2, 128), np.float32)
    half[0, 0] = 127.0                   # scale 1: x / scale lands on .5
    half[0, 1:7] = [0.5, 1.5, 2.5, -0.5, -2.5, 126.5]
    zero_block = (rng.standard_normal((3, 256)) * 3).astype(np.float32)
    zero_block[1, 128:] = 0.0
    return [("ragged 7", rng.standard_normal((5, 7)), "float32"),
            ("ragged 130", rng.standard_normal((9, 130)) * 5, "float32"),
            ("all-zero block", zero_block, "float32"),
            (".5 after division", half, "float32"),
            ("bf16", rng.standard_normal((64, 384)) * 3, "bfloat16"),
            ("rank 3", rng.standard_normal((4, 2, 96)), "float32"),
            ("rank 4", rng.standard_normal((3, 5, 7, 130)), "float32"),
            ("mlp weight", rng.standard_normal((256, 2048)) * 0.02,
             "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("label,x,dtype", quantize_cases(),
                         ids=[c[0] for c in quantize_cases()])
def test_cuda_quantize_bit_equal_plain(cuda, label, x, dtype):
    t = torch.as_tensor(np.asarray(x, np.float32), device=cuda).to(
        getattr(torch, dtype))
    before = launch_counts()["quantize_blockwise"]
    q, s = qb.quantize_blockwise(t)
    q_p, s_p = qb.quantize_blockwise_plain(t)
    torch.cuda.synchronize()
    assert launch_counts()["quantize_blockwise"] == before + 1
    assert torch.equal(q, q_p) and torch.equal(s, s_p)


DEQUANTIZE_SHAPES = [(8, 64), (4, 128), (6, 200), (3, 384), (200,), (384,),
                     (2, 3, 200), (2, 2, 3, 384), (5, 7), (9, 130),
                     (64, 32, 64), (2048,)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DEQUANTIZE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_cuda_dequantize_bit_equal_plain(cuda, shape, dtype, aligned):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    if shape[-1] > 128:
        x[..., :128] = 0.0                  # an all-zero block
    q, s = qb.quantize_blockwise_plain(torch.as_tensor(x, device=cuda))
    if not aligned:   # a contiguous q at an odd address: the 1-wide path
        buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
        q = buf[1:].view(q.shape).copy_(q)
    dt = getattr(torch, dtype)
    before = launch_counts()["dequantize_blockwise"]
    got = qb.dequantize_blockwise(q, s, dtype=dt)
    want = qb.dequantize_blockwise_plain(q, s, dtype=dt)
    torch.cuda.synchronize()
    assert launch_counts()["dequantize_blockwise"] == before + 1
    assert got.dtype == want.dtype == dt and got.shape == q.shape
    as_int = torch.int16 if dt == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(as_int), want.view(as_int))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 128, 100), (3, 384, 70),
                                   (4, 2048, 5632), (4, 5632, 2048),
                                   (512, 384, 130), (512, 2048, 200)])
def test_cuda_dequant_matmul_close_to_plain(cuda, m, k, n):
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(m + k + n)
    a = torch.as_tensor(rng.standard_normal((m, k)).astype(np.float32),
                        device=cuda)
    w = torch.as_tensor((rng.standard_normal((k, n)) * 0.02).astype(
        np.float32), device=cuda)
    qw, s = qb.quantize_blockwise_plain(w.t().contiguous())
    qw, s = qw.t().contiguous(), s.t().contiguous()
    before = launch_counts()["dequant_matmul"]
    got = dm.dequant_matmul(a, qw, s)
    want = dm.dequant_matmul_plain(a, qw, s)
    torch.cuda.synchronize()
    assert launch_counts()["dequant_matmul"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 15, 16, 17, 64, 512])
@pytest.mark.parametrize("k", [128, 384, 2048])
@pytest.mark.parametrize("n", [70, 200, 5632])
def test_cuda_dequant_matmul_both_routes_deterministic(cuda, m, k, n):
    """The split-K decode kernel (M up to its threshold) and the
    tensor-core prefill kernel (above it), around the threshold and with
    masked M and N, within rtol and atol 1e-4 of the plain version; two
    calls give the same bits (a fixed-order split-K sum, no atomics)."""
    rng = np.random.default_rng(m * 7 + k + n)
    a = torch.as_tensor(rng.standard_normal((m, k)).astype(np.float32),
                        device=cuda)
    w = torch.as_tensor((rng.standard_normal((k, n)) * 0.02).astype(
        np.float32), device=cuda)
    qw, s = qb.quantize_blockwise_plain(w.t().contiguous())
    qw, s = qw.t().contiguous(), s.t().contiguous()
    got = dm.dequant_matmul(a, qw, s)
    again = dm.dequant_matmul(a, qw, s)
    want = dm.dequant_matmul_plain(a, qw, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_cuda_dequant_matmul_rejects_k_off_the_block(cuda):
    a = torch.zeros((4, 200), device=cuda)
    qw = torch.zeros((200, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of block"):
        dm.dequant_matmul(a, qw, torch.ones((1, 64), device=cuda))


def group_items(device, n_items=None, seed=0):
    """A mixed dequantize group: ranks 1-4, ragged last blocks, last
    dimensions under one block, float32 and bfloat16 outputs, one q at an
    odd address; or `n_items` small tensors."""
    rng = np.random.default_rng(seed)
    shapes = ([(2048,), (300,), (7,), (32, 64), (9, 130), (128, 256),
               (3, 5, 200), (2, 3, 4, 384), (2, 2, 2, 129), (1000,)]
              if n_items is None else
              [(int(rng.integers(1, 4)), int(rng.integers(1, 300)))
               for _ in range(n_items)])
    items = []
    for i, shape in enumerate(shapes):
        x = torch.as_tensor((rng.standard_normal(shape) * 3).astype(
            np.float32), device=device)
        q, s = qb.quantize_blockwise_plain(x)
        if i == 4:        # a contiguous q at an odd address
            buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=device)
            q = buf[1:].view(q.shape).copy_(q)
        dt = torch.bfloat16 if i % 3 == 1 else torch.float32
        items.append((q, s, torch.full(shape, float("nan"), dtype=dt,
                                       device=device)))
    return items


def assert_group_bit_equal(items):
    for q, s, out in items:
        want = qb.dequantize_blockwise_plain(q, s, dtype=out.dtype)
        as_int = torch.int16 if out.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(out.view(as_int), want.view(as_int))


@pytest.mark.cuda
def test_cuda_dequantize_group_bit_equal_plain_one_launch(cuda):
    items = group_items(cuda)
    before = launch_counts()["dequantize_blockwise"]
    qb.dequantize_blockwise_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["dequantize_blockwise"] == before + 1
    assert_group_bit_equal(items)


@pytest.mark.cuda
def test_cuda_dequantize_group_longer_than_one_struct(cuda):
    cap = qb.group_capacity()
    items = group_items(cuda, n_items=cap + 5, seed=1)
    before = launch_counts()["dequantize_blockwise"]
    qb.dequantize_blockwise_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["dequantize_blockwise"] == before + 2
    assert_group_bit_equal(items)


@pytest.mark.cuda
def test_cuda_dequantize_splits_large_tensors_by_rows(cuda, monkeypatch):
    """A tensor of 2^31 elements or more goes as several kernel items of
    whole rows (`_MAX_ITEM` made small here): one launch, the same bits."""
    monkeypatch.setattr(qb, "_MAX_ITEM", 5000)
    items = group_items(cuda, seed=2)
    before = launch_counts()["dequantize_blockwise"]
    qb.dequantize_blockwise_group(items)
    single = [qb.dequantize_blockwise(q, s, dtype=out.dtype)
              for q, s, out in items]
    torch.cuda.synchronize()
    assert max(q.numel() for q, _, _ in items) > 5000
    # one launch for the group, one for each single call
    assert launch_counts()["dequantize_blockwise"] == before + 1 + len(items)
    assert_group_bit_equal(items)
    for (q, s, out), got in zip(items, single):
        as_int = torch.int16 if out.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(as_int), out.view(as_int))


@pytest.mark.cuda
def test_cuda_q8_wire_one_launch_per_bucket(cuda, monkeypatch):
    from repro_torch.train import step
    rng = np.random.default_rng(3)
    grads = {f"g{i}": torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device=cuda) for i, shape in enumerate(
            [(64, 256), (4,), (2048,), (16, 2, 64), (300, 130), (5, 7)])}
    want = {k: qb.dequantize_blockwise_plain(*qb.quantize_blockwise_plain(g))
            if step.on_wire(g) else g.clone() for k, g in grads.items()}
    monkeypatch.setattr(step, "WIRE_BUCKET_BYTES", 20_000)
    n_buckets = len(step.wire_buckets(list(grads.values())))
    assert n_buckets == 3
    before = launch_counts()
    step.q8_wire(grads)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["dequantize_blockwise"] == \
        before["dequantize_blockwise"] + n_buckets
    assert after["quantize_blockwise"] == \
        before["quantize_blockwise"] + n_buckets
    for k, g in grads.items():
        assert torch.equal(g.view(torch.int32), want[k].view(torch.int32))


def quantize_group_items(device, shapes, seed=0, block=qb.DEFAULT_BLOCK):
    """(x, q, scales) items of seeded data: every third x bfloat16, q
    starting at 99 and the scales as NaN, so an element left unwritten
    shows."""
    rng = np.random.default_rng(seed)
    items = []
    for i, shape in enumerate(shapes):
        x = torch.as_tensor((rng.standard_normal(shape) * 3).astype(
            np.float32), device=device)
        if i % 3 == 1:
            x = x.to(torch.bfloat16)
        nb = -(-shape[-1] // block)
        items.append((x, torch.full(shape, 99, dtype=torch.int8,
                                    device=device),
                      torch.full((*shape[:-1], nb), float("nan"),
                                 device=device)))
    return items


def assert_quantized_bit_equal(items, block=qb.DEFAULT_BLOCK):
    for x, q, s in items:
        q_p, s_p = qb.quantize_blockwise_plain(x, block)
        assert torch.equal(q, q_p), tuple(x.shape)
        assert torch.equal(s.view(torch.int32), s_p.view(torch.int32))


MIXED = [(2048,), (300,), (7,), (3,), (32, 64), (9, 130), (128, 256),
         (3, 5, 200), (2, 3, 4, 384), (2, 2, 2, 129), (1000,), (0, 5),
         (40, 8), (6, 1)]


@pytest.mark.cuda
def test_cuda_quantize_group_bit_equal_plain_one_launch(cuda):
    items = quantize_group_items(cuda, MIXED)
    before = launch_counts()["quantize_blockwise"]
    qb.quantize_blockwise_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["quantize_blockwise"] == before + 1
    assert_quantized_bit_equal(items)


@pytest.mark.cuda
def test_cuda_quantize_group_longer_than_one_struct(cuda):
    cap = qb.group_capacity()
    rng = np.random.default_rng(1)
    shapes = [(int(rng.integers(1, 4)), int(rng.integers(1, 300)))
              for _ in range(cap + 5)]
    items = quantize_group_items(cuda, shapes, seed=1)
    before = launch_counts()["quantize_blockwise"]
    qb.quantize_blockwise_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["quantize_blockwise"] == before + 2
    assert_quantized_bit_equal(items)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["x", "q", "both"])
def test_cuda_quantize_group_on_unaligned_views(cuda, dtype, where):
    """x or q one element past an aligned address: the kernel's one
    element at a time path, the same bits."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    items = []
    for shape in [(37, 256), (5, 130), (64,)]:
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                            device=cuda).to(dt)
        q = torch.empty(shape, dtype=torch.int8, device=cuda)
        if where in ("x", "both"):
            buf = torch.empty(x.numel() + 1, dtype=dt, device=cuda)
            x = buf[1:].view(shape).copy_(x)
        if where in ("q", "both"):
            buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
            q = buf[1:].view(shape)
        items.append((x, q, torch.empty((*shape[:-1], -(-shape[-1] // 128)),
                                        device=cuda)))
    before = launch_counts()["quantize_blockwise"]
    qb.quantize_blockwise_group(items)
    torch.cuda.synchronize()
    assert launch_counts()["quantize_blockwise"] == before + 1
    assert_quantized_bit_equal(items)
    if where == "x":                          # and the single call
        for x, q, s in items:
            q1, s1 = qb.quantize_blockwise(x)
            assert torch.equal(q1, q) and torch.equal(s1, s)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 6, 64, 100, 256])
def test_cuda_quantize_group_other_blocks(cuda, block):
    items = quantize_group_items(cuda, [(3, 300), (7,), (4, 2, 129),
                                        (1, 1000), (50, 64)], seed=block,
                                 block=block)
    qb.quantize_blockwise_group(items, block)
    torch.cuda.synchronize()
    assert_quantized_bit_equal(items, block)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quantize_at_the_int8_boundaries(cuda, dtype):
    """x / scale on and a few ulps around every k + .5 (k in -127..126)
    and at +-127, under random scales: the IEEE division and round half to
    even of the plain version, bit for bit."""
    rng = np.random.default_rng(3)
    k = rng.integers(-127, 127, size=(8192, 128)).astype(np.float32)
    scale = rng.uniform(1e-6, 1e3, size=(8192, 1)).astype(np.float32)
    x = (k + 0.5) * scale
    x[:, 0] = 127 * scale[:, 0]
    x[:, 1] = -127 * scale[:, 0]
    x *= (1 + rng.integers(-3, 4, size=x.shape) * 2.0 ** -23).astype(
        np.float32)
    t = torch.as_tensor(x.astype(np.float32), device=cuda).to(
        getattr(torch, dtype))
    items = [(t, torch.empty(t.shape, dtype=torch.int8, device=cuda),
              torch.empty((8192, 1), device=cuda))]
    qb.quantize_blockwise_group(items)
    q1, s1 = qb.quantize_blockwise(t)
    torch.cuda.synchronize()
    assert_quantized_bit_equal(items)
    assert torch.equal(q1, items[0][1]) and torch.equal(s1, items[0][2])


@pytest.mark.cuda
def test_cuda_quantize_splits_large_tensors_by_rows(cuda, monkeypatch):
    """A tensor of 2^31 elements or more goes as several kernel items of
    whole rows (`_MAX_ITEM` made small here): one launch, the same bits,
    grouped and single."""
    monkeypatch.setattr(qb, "_MAX_ITEM", 5000)
    items = quantize_group_items(cuda, [(2048,), (300, 130), (100, 384),
                                        (7,), (64, 4, 64)], seed=4)
    before = launch_counts()["quantize_blockwise"]
    qb.quantize_blockwise_group(items)
    single = [qb.quantize_blockwise(x) for x, _, _ in items]
    torch.cuda.synchronize()
    assert max(x.numel() for x, _, _ in items) > 5000
    # one launch for the group, one for each single call
    assert launch_counts()["quantize_blockwise"] == before + 1 + len(items)
    assert_quantized_bit_equal(items)
    for (_, q, s), (q1, s1) in zip(items, single):
        assert torch.equal(q1, q) and torch.equal(s1, s)


@pytest.mark.cuda
def test_cuda_adamw_q8_one_launch_each_way_per_parameter(cuda):
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    rng = np.random.default_rng(5)
    shapes = {"w": (64, 256), "b": (130,), "n": (3, 4, 64)}
    params = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.as_tensor(
        rng.standard_normal(sh).astype(np.float32), device=cuda))
        for k, sh in shapes.items()})
    cfg = AdamWConfig(lr=1e-2, state_codec="q8")
    state = adamw_init(params, cfg)
    grads = {k: torch.as_tensor(rng.standard_normal(sh).astype(np.float32),
                                device=cuda) for k, sh in shapes.items()}
    before = launch_counts()
    adamw_update(params, grads, state, cfg)
    torch.cuda.synchronize()
    after = launch_counts()
    for name in ("quantize_blockwise", "dequantize_blockwise"):
        assert after[name] == before[name] + len(shapes)
    # from zero moments: m = (1 - b1) g and sqrt(v) = sqrt((1 - b2) g g),
    # the same ops on the same device, then the plain quantize
    for k, mom in state["moments"].items():
        zero = torch.zeros_like(grads[k])
        m = cfg.b1 * zero + (1 - cfg.b1) * grads[k]
        v = cfg.b2 * (zero * zero) + (1 - cfg.b2) * grads[k] * grads[k]
        for name, t in (("m", m), ("v", torch.sqrt(v))):
            q_p, s_p = qb.quantize_blockwise_plain(t)
            assert torch.equal(q_p, mom[f"{name}_q"])
            assert torch.equal(s_p, mom[f"{name}_s"])


@pytest.mark.cuda
def test_cuda_q8_checkpoint_equals_the_cpu_copys(cuda, tmp_path):
    """A q8+zlib checkpoint of a small model and its q8 AdamW state written
    from the card is byte-identical to the one written from its CPU copy
    (one grouped quantize launch), and a restore into templates on the
    card equals the plain dequantize of the plain quantize (one grouped
    dequantize launch)."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.models import model as MD
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    cfg = ModelConfig("odd", "dense", 2, 96, 4, 2, 200, 300, d_head=24)
    params = MD.init_params(torch.Generator(cuda).manual_seed(0), cfg, cuda)
    ocfg = AdamWConfig(lr=1e-2, state_codec="q8")
    state = adamw_init(params, ocfg)
    gen = torch.Generator(cuda).manual_seed(1)
    adamw_update(params, {n: torch.randn(p.shape, generator=gen, device=cuda)
                          for n, p in params.named_parameters()}, state, ocfg)
    cpu = MD.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    cpu.load_state_dict(params.state_dict())
    cpu_state = {"step": state["step"].cpu(),
                 "moments": {n: {k: v.cpu() for k, v in m.items()}
                             for n, m in state["moments"].items()}}
    n_params = len(list(params.parameters()))
    before = launch_counts()
    for where, p, st in (("card", params, state), ("cpu", cpu, cpu_state)):
        CheckpointManager(CheckpointConfig(str(tmp_path / where),
                                           params_codec="q8+zlib")).save(
            1, p, st)
    assert launch_counts()["quantize_blockwise"] == \
        before["quantize_blockwise"] + -(-n_params // qb.group_capacity())
    card, host = (tmp_path / w / "step_00000001" for w in ("card", "cpu"))
    names = sorted(f.name for f in card.iterdir())
    assert names == sorted(f.name for f in host.iterdir())
    for name in names:
        assert (card / name).read_bytes() == (host / name).read_bytes(), name
    fresh = MD.init_params(torch.Generator(cuda).manual_seed(2), cfg, cuda)
    fresh_state = adamw_init(fresh, ocfg)
    before = launch_counts()
    CheckpointManager(CheckpointConfig(str(tmp_path / "cpu"))).restore_into(
        fresh, fresh_state)
    torch.cuda.synchronize()
    assert launch_counts()["dequantize_blockwise"] == \
        before["dequantize_blockwise"] + -(-n_params // qb.group_capacity())
    for (name, p), f in zip(params.named_parameters(), fresh.parameters()):
        want = qb.dequantize_blockwise_plain(*qb.quantize_blockwise_plain(p))
        assert torch.equal(f.view(torch.int32), want.view(torch.int32)), name
    for name, m in state["moments"].items():
        for k, t in m.items():
            assert torch.equal(fresh_state["moments"][name][k], t), (name, k)
    assert fresh_state["step"].device == cuda
    assert int(fresh_state["step"]) == 1


def no_sort(monkeypatch):
    def fail(*a, **kw):
        raise AssertionError("a sort on GDICT's card path")
    for mod, name in ((torch, "sort"), (torch, "argsort"), (torch, "unique"),
                      (torch, "msort"), (torch.Tensor, "sort"),
                      (torch.Tensor, "argsort"), (torch.Tensor, "unique")):
        monkeypatch.setattr(mod, name, fail)


@pytest.mark.cuda
@pytest.mark.parametrize("n", GDICT_EDGE_NS)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "row offset"])
def test_cuda_gdict_edge_cases_equal_plain(cuda, monkeypatch, n, offset):
    """GDICT's hash set on its edge rows (INT64_MIN, its empty-slot marker,
    present and absent; 3 and n distinct values; values differing only in
    their high or low 32 bits) at each layout's size limits +-1: a block's
    shared memory, a cluster's, global memory; one launch, no sort; rows
    from the second on (not 16-byte aligned where n is odd)."""
    cols, widths = gdict_edge_stack(n, n)
    want = cb.gdict_bytes_plain(torch.as_tensor(cols),
                                torch.as_tensor(widths))[offset:]
    c = torch.as_tensor(cols, device=cuda)[offset:]
    w = torch.as_tensor(widths, device=cuda)[offset:]
    no_sort(monkeypatch)
    before = launch_counts()["gdict_bytes"]
    got = cb.gdict_bytes(c, w)
    torch.cuda.synchronize()
    assert launch_counts()["gdict_bytes"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1, 60000), (11, 60000), (801, 60000),
                                 (801, 4682), (1, 74899), (200, 74899),
                                 (5000, 300)])
def test_cuda_gdict_stacks_equal_plain(cuda, monkeypatch, m, n):
    """GDICT on stacks of the edge rows over again: one row, the main
    path's 11, the advisor's widest 801 (clusters of 8 and of 1 behind
    many rows), global tables for 1 and 200 rows, 5,000 short rows."""
    cols, widths = gdict_edge_stack(n, m)
    reps = -(-m // len(cols))
    cols = np.tile(cols, (reps, 1))[:m]
    widths = np.tile(widths, reps)[:m]
    want = cb.gdict_bytes_plain(torch.as_tensor(cols),
                                torch.as_tensor(widths))
    c = torch.as_tensor(cols, device=cuda)
    w = torch.as_tensor(widths, device=cuda)
    no_sort(monkeypatch)
    got = cb.gdict_bytes(c, w)
    again = cb.gdict_bytes(c, w)
    assert torch.equal(got.cpu(), want) and torch.equal(again, got)


@pytest.mark.cuda
def test_cuda_session_rounds_equal_fresh_recommend(cuda):
    """A small session's three rounds on the card (cold, a structural
    delta, a reweight-only delta) each `==` a fresh cuda recommend; one
    planner_walk launch per re-planned round, none on the reweight-only
    round, and no per-record fused_score or prob_within launch."""
    import dataclasses
    from repro_torch import core as pt
    schema = pt.make_tpch_like(scale=0.15, z=0, seed=0)
    wl = pt.make_scaled_workload(schema, n_statements=40, seed=2)
    extra = [dataclasses.replace(s, name=f"d{i:03d}") for i, s in
             enumerate(pt.make_scaled_workload(schema, n_statements=4,
                                               seed=9).statements)]
    names = [s.name for s in wl.statements]
    opt = pt.AdvisorOptions(backend="torch", device="cuda", methods=(
        "NS", "GDICT", "LDICT", "PREFIX", "RLE"))
    budget = 0.3 * sum(pt.SizeProvider(schema).size(i) for i in
                       pt.base_configuration(schema).indexes)
    sess = pt.AdvisorSession(wl, opt)
    rounds = [(None, 1),
              (pt.WorkloadDelta(added=tuple(extra), removed=(names[5],),
                                reweighted=((names[0], 3.0),)), 1),
              (pt.WorkloadDelta(reweighted=((names[1], 0.5),)), 0)]
    for delta, walks in rounds:
        if delta is not None:
            sess.apply(delta)
            wl = wl.apply_delta(delta)
        before = launch_counts()
        got = sess.recommend(budget)
        after = launch_counts()
        d = {k: after[k] - before[k] for k in after}
        assert d["planner_walk"] == walks
        assert d["fused_score"] == d["prob_within"] == 0
        if not walks:
            assert not any(d.values())
        want = pt.DesignAdvisor(wl, opt).recommend(budget)
        for name in ("config", "cost", "used_bytes", "base_cost",
                     "n_sampled", "n_deduced", "estimation_cost_pages",
                     "pool_size", "candidate_count"):
            assert getattr(got, name) == getattr(want, name), name


@pytest.mark.cuda
def test_cuda_fleet_rounds_equal_fresh_recommend(cuda):
    """A 3-tenant fleet on the card over two rounds of one delta and one
    recommend a tenant: every recommendation `==` a fresh cuda
    recommend; the shared prefetch launches the codec kernels, each
    re-planned tenant walks, and the stacked cost phase feeds every
    recommend (no per-record fused_score or prob_within launch)."""
    import dataclasses
    from repro_torch import core as pt
    from repro_torch.serve.advisor_service import (AdvisorFleetService,
                                                   FleetConfig)
    schema = pt.make_tpch_like(scale=0.1, z=0, seed=0)
    opt = pt.AdvisorOptions(backend="torch", device="cuda")
    fleet = AdvisorFleetService(FleetConfig(slots=3))
    wls = {}
    for i in range(3):
        tid = f"t{i}"
        wl = pt.make_scaled_workload(schema, n_statements=12, seed=60 + i)
        wls[tid] = dataclasses.replace(wl, statements=[
            dataclasses.replace(s, name=f"{tid}_{s.name}")
            for s in wl.statements])
        fleet.register_tenant(tid, wls[tid], opt)
    assert fleet.tenants["t0"].group.engine.device == cuda
    fleet_launches = {}
    for rnd in range(2):
        before = launch_counts()
        tks = {}
        for i, tid in enumerate(wls):
            extra = pt.make_scaled_workload(schema, n_statements=2,
                                            seed=500 + 10 * rnd + i)
            d = pt.WorkloadDelta(added=tuple(
                dataclasses.replace(s, name=f"{tid}_r{rnd}_{s.name}")
                for s in extra.statements))
            fleet.submit_delta(tid, d)
            wls[tid] = wls[tid].apply_delta(d)
            tks[tid] = fleet.submit_recommend(tid, 2e6)
        fleet.run_until_drained()
        after = launch_counts()
        d = {k: after[k] - before[k] for k in after}
        for k, v in d.items():
            fleet_launches[k] = fleet_launches.get(k, 0) + v
        assert 1 <= d["planner_walk"] <= 3
        assert d["fused_score"] == d["prob_within"] == 0
        for tid, tk in tks.items():
            got = tk.result()
            assert tk.prefetch_error is None, (rnd, tid, tk.prefetch_error)
            want = pt.DesignAdvisor(wls[tid], opt).recommend(2e6)
            for name in ("config", "cost", "used_bytes", "base_cost",
                         "n_sampled", "n_deduced", "estimation_cost_pages",
                         "pool_size", "candidate_count"):
                assert getattr(got, name) == getattr(want, name), (rnd, tid)
    assert fleet_launches["ns_bytes"] > 0
    assert fleet_launches["ldict_bytes"] > 0
    st = fleet.stats
    consumed = sum(t.session.cost_prefetch_consumed
                   for t in fleet.tenants.values())
    assert consumed == st["cost_prefetch_jobs"] > 0
    assert st["prefetch_batches"] > 0
    # no fault is injected: no prefetch fails, one stacked cost batch a round
    assert st["prefetch_failures"] == 0
    assert st["cost_prefetch_batches"] == 2


@pytest.mark.cuda
def test_cuda_stacked_costs_bitwise_equal_per_job(cuda):
    """`batched_candidate_costs` on the card: every row bit-equal to the
    job's per-job `candidate_query_costs` on the card (the same float32
    op sequence; a (J, m) broadcast against the per-job (m,) call)."""
    from repro_torch import core as pt
    from repro_torch.core import candidates as cand
    from repro_torch.core.cost_engine import batched_candidate_costs
    schema = pt.make_tpch_like(scale=0.2, z=0, seed=0)
    wl = pt.make_tpch_workload(schema, insert_weight=0.1)
    adv = pt.DesignAdvisor(wl, pt.AdvisorOptions(backend="numpy"))
    base = pt.base_configuration(schema)
    eng = pt.CostEngine(wl, adv.sizes, device=cuda)
    jobs, per_job = [], []
    for q in wl.queries():
        raw = cand.syntactically_relevant(q, schema.tables[q.table])
        raw = cand.expand_with_compression(raw, ("NS", "LDICT"))
        adv.estimate_sizes(raw)
        jobs.append(eng.cost_job_arrays(q, base, raw))
        per_job.append(eng.candidate_query_costs(q, base, raw))
    costs = batched_candidate_costs(jobs, device=cuda)
    for i, want in enumerate(per_job):
        np.testing.assert_array_equal(costs[i, :len(want)], want)
