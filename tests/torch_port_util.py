"""Shared helpers of the tests that hold the PyTorch port (`repro_torch`)
against the JAX package (`repro`): hand the reference's exact schema and
workload to the port as plain data, and compare configurations of the
two packages by their index labels."""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import torch

import repro_torch.core as pt


def port_schema(ref_schema) -> "pt.Schema":
    tables = {name: ([(c.name, c.width) for c in t.columns], t.values)
              for name, t in ref_schema.tables.items()}
    fks = [(fk.fact_table, fk.fk_col, fk.dim_table, fk.dim_key)
           for fk in ref_schema.foreign_keys]
    return pt.schema_from_arrays(tables, fks)


def port_workload(ref_workload, schema=None) -> "pt.Workload":
    schema = schema if schema is not None else \
        port_schema(ref_workload.schema)
    spec = []
    for s in ref_workload.statements:
        if hasattr(s, "filters"):
            spec.append(("query", s.name, s.table,
                         [(p.col, p.lo, p.hi) for p in s.filters],
                         list(s.cols_used), s.weight))
        else:
            spec.append(("insert", s.name, s.table, s.nrows, s.weight))
    return pt.workload_from_spec(schema, spec)


def labels(config) -> list:
    return sorted(i.label() for i in config.indexes)


def tables_equal(ref_schema, port_schema_) -> bool:
    if list(ref_schema.tables) != list(port_schema_.tables):
        return False
    for name, t in ref_schema.tables.items():
        p = port_schema_.tables[name]
        if [(c.name, c.width) for c in t.columns] != \
                [(c.name, c.width) for c in p.columns]:
            return False
        if not all(np.array_equal(t.values[c.name], p.values[c.name])
                   for c in t.columns):
            return False
    return True


def statement_spec(s) -> tuple:
    """A statement of either package as plain data."""
    if hasattr(s, "filters"):
        return ("query", s.name, s.table,
                tuple((p.col, int(p.lo), int(p.hi)) for p in s.filters),
                tuple(s.cols_used), float(s.weight))
    return ("insert", s.name, s.table, int(s.nrows), float(s.weight))


def port_config(ref_config) -> "pt.Configuration":
    """The port's Configuration of a reference configuration of
    predicate-free indexes."""
    assert all(i.predicate is None for i in ref_config.indexes)
    return pt.Configuration.of(
        pt.IndexDef(i.table, tuple(i.cols), i.compression, i.clustered)
        for i in ref_config.indexes)


def assert_same_steps_up_to_ping_pong(got_steps, want_steps) -> None:
    """Greedy steps equal, except that one run may go on where the other
    stopped with steps that leave the cost unchanged: the float32 greedy
    swapping two tied clustered layouts until the step limit (ROADMAP.md
    Queue C), which the two float32 backends need not both fall into."""
    k = min(len(got_steps), len(want_steps))
    assert got_steps[:k] == want_steps[:k]
    for step in (got_steps[k:] or want_steps[k:]):
        before, after = step.rsplit("cost ", 1)[1].split("->")
        assert before == after, step


# ---------------------------------------------------------------------------
# hand-built planner graphs for `planner_walk` (shared with the card tests)
# ---------------------------------------------------------------------------

def walk_graph(spec: dict, device="cpu"):
    """A `planner_score.WalkGraph` from a plain spec: n nodes (the EXACT pad
    is node n), nf fractions, records [(target, kind, [(children, (dm, vt,
    mq)), ...]), ...] in order, scost (n, nf), samp_mean / samp_std (2, nf);
    the plan's targets are spec["targets"], by default the records'."""
    import torch
    from repro_torch.kernels import planner_score as ps
    n, nf, recs = spec["n"], spec["nf"], spec["recs"]
    k = max([1] + [len(ch) for _, _, cands in recs for ch, _ in cands])
    off = np.zeros(len(recs) + 1, dtype=np.int32)
    off[1:] = np.cumsum([len(cands) for _, _, cands in recs])
    child = np.full((int(off[-1]), k), n, dtype=np.int32)
    nchild = np.zeros(int(off[-1]), dtype=np.int32)
    fac = np.zeros((int(off[-1]), 3), dtype=np.float32)
    c = 0
    for _, _, cands in recs:
        for ch, f in cands:
            child[c, :len(ch)] = ch
            nchild[c] = len(ch)
            fac[c] = f
            c += 1
    scost = np.zeros((n + 1, nf))
    scost[:n] = spec["scost"]

    def t(a, dt):
        return torch.as_tensor(np.asarray(a, dtype=dt), device=device)
    return ps.WalkGraph(
        t([r[0] for r in recs], np.int32), t([r[1] for r in recs], np.int32),
        t(off, np.int32), t(child, np.int32), t(nchild, np.int32),
        t(fac[:, 0], np.float32), t(fac[:, 1], np.float32),
        t(fac[:, 2], np.float32), t(scost, np.float64),
        t(spec["samp_mean"], np.float64), t(spec["samp_std"], np.float64),
        t(spec.get("targets", [r[0] for r in recs]), np.int32),
        max_cands=max([0] + [len(cands) for _, _, cands in recs]))


def walk_synthetic(n: int, nrec: int, nf: int, seed: int,
                   used: int = None) -> dict:
    """A random `walk_graph` spec: nrec records (targets drawn with
    repeats) over `used` of the n nodes (all by default), 0-29 candidates
    each of 1-6 children (shared, repeated, the target itself), random
    deduction factors, costs and SampleCF RVs."""
    r = np.random.default_rng(seed)
    used = n if used is None else used
    ids = np.arange(n) if used == n else np.sort(r.choice(n, used,
                                                          replace=False))
    recs = []
    for _ in range(nrec):
        cands = []
        for _ in range(int(r.integers(0, 30))):
            dmv, sdv = r.uniform(0.95, 1.05), r.uniform(0.0, 0.05)
            ch = ids[r.integers(0, used, int(r.integers(1, 7)))]
            cands.append(([int(x) for x in ch],
                          (dmv, sdv * sdv + dmv * dmv, dmv * dmv)))
        recs.append((int(ids[r.integers(0, used)]), int(r.integers(0, 2)),
                     cands))
    return {"n": n, "nf": nf, "recs": recs,
            "scost": r.uniform(1.0, 100.0, (n, nf)),
            "samp_mean": r.uniform(0.9, 1.1, (2, nf)),
            "samp_std": r.uniform(0.01, 0.3, (2, nf))}


# factors of a deduction whose error RV has mean 1 and std 0.01
DED = (1.0, 1.0 + 0.01 ** 2, 1.0)
BIG = 2.0 ** 53
MID = 2.0 ** 24

# float64 costs and sums (traps b-e), a float64 SampleCF mean (f),
# a duplicate target (g)
WALK_SUMS = {
    "n": 12, "nf": 1,
    "recs": [
        # lines 8-9: extras 2^53 + 2 and, in child order, 2^53 + 1 + 1 =
        # 2^53 (any other order or float32 ties them); the first argmin is
        # candidate 1
        (4, 0, [([3], DED), ([0, 1, 2], DED)]),
        # extra 2^24 + 3 < cost 2^24 + 3.5 in float64 (equal in float32)
        (9, 0, [([8], DED)]),
        # extras 2^24 + 1 and 2^24 + 0.5: float32 ties them
        (10, 0, [([5], DED), ([6], DED)]),
        # lines 6-7 on children sampled by earlier records
        (11, 1, [([0, 8], DED)]),
        (4, 0, [([3], DED)]),                       # a duplicate target
        (7, 1, []),                                 # no candidates
    ],
    "scost": [[BIG], [1.0], [1.0], [BIG + 2], [BIG + 4], [MID + 1],
              [MID + 0.5], [1.0], [MID + 3], [MID + 3.5], [MID + 2], [3.0]],
    "samp_mean": [[1.0 + 1e-9], [1.0 - 1e-9]],
    "samp_std": [[0.01], [0.02]],
}
WALK_SUMS_WIN = [[(1 << 20) + 1], [1 << 20], [(1 << 20) + 1], [0], [-1],
                 [-2]]

# ties and shared children over three fractions: tied p and tied extra
# (the first candidate wins), a child shared by two candidates, children
# sampled by an earlier record, a fraction whose SampleCF error is too
# wide for any deduction
WALK_TIES = {
    "n": 10, "nf": 3,
    "recs": [
        (4, 0, [([0, 1], DED), ([0, 1], DED), ([2], DED)]),
        (5, 0, [([0, 3], DED), ([1, 3], DED)]),
        (6, 1, [([4, 5], DED)]),
        (4, 0, [([2], DED)]),
        (7, 1, [([2], DED), ([2], DED)]),
        (8, 1, [([0], DED), ([0], DED)]),
        (9, 1, []),
    ],
    "scost": [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [5.0, 5.0, 0.5],
              [2.0, 2.0, 2.0], [10.0, 1.5, 10.0], [4.0, 4.0, 4.0],
              [9.0, 9.0, 9.0], [6.0, 6.0, 6.0], [3.0, 3.0, 3.0],
              [1.0, 2.0, 3.0]],
    "samp_mean": [[1.0 + 1e-9, 0.98, 1.05], [1.01, 1.0, 0.97]],
    "samp_std": [[0.01, 0.05, 0.5], [0.02, 0.03, 0.3]],
}
L9 = 1 << 20
WALK_TIES_WIN = [[L9, -2, -2], [L9, L9, -2], [0, 0, -2], [-1, -1, -1],
                 [L9, L9, -2], [0, 0, -2], [-2, -2, -2]]

# node 1's only candidate has the known child 0 (sampled by record 0):
# with q the next float64 above float64(p) of its score (float32(q) == p)
# it must fail lines 6-7 (trap a); TRAP_A_E is the accuracy bound e
WALK_TRAP_A = {
    "n": 2, "nf": 1,
    "recs": [(0, 0, []), (1, 0, [([0], DED)])],
    "scost": [[1.0], [2.0]],
    "samp_mean": [[1.0], [1.0]], "samp_std": [[0.2], [0.2]],
}
TRAP_A_E = 0.3


def trap_a_score(device="cpu") -> float:
    """p of WALK_TRAP_A's candidate, scored by `fused_score` on `device`."""
    import torch
    from repro_torch.kernels import planner_score as ps
    f32 = float(np.float32(0.2))
    m = torch.ones((1, 1, 1), device=device)
    s = torch.full((1, 1, 1), f32, device=device)
    fac = [torch.tensor([v], dtype=torch.float32, device=device)
           for v in DED]
    mask = torch.ones((1, 1), dtype=torch.bool, device=device)
    return float(ps.fused_score(m, s, *fac, mask, None, None, TRAP_A_E,
                                0.5)[2][0, 0])


# ---------------------------------------------------------------------------
# codec edge inputs where the RLE and NS kernels cut their work (shared
# with the card tests)
# ---------------------------------------------------------------------------

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
# rows per page around a warp's 64 values a step (32 lanes, 16-byte pairs),
# the warp / block split at 512 rows, the main path's 273 and the largest
PAGE_EDGE_RPPS = (1, 2, 63, 64, 65, 273, 511, 512, 513, 1638)
# row lengths around NS's split of a row over 1-8 blocks (>= 1,024 values
# a block, 2,048 values a block step) and the main path's 60,000
NS_EDGE_NS = (1, 2, 3, 7, 2047, 2048, 2049, 4095, 4096, 4097, 8191, 8192,
              8193, 16383, 16384, 16385, 32767, 32768, 32769, 60000, 60001)


def page_edge_n(rpp: int, pages: str) -> int:
    """A ragged last page after three whole ones, or one page short of
    rpp."""
    return 3 * rpp + rpp // 2 + 1 if pages == "ragged" else max(1, rpp - 3)


def run_edge_stack(n: int, rpp: int, seed: int, signed: bool):
    """(cols, widths) of rows whose runs start where the RLE kernels cut a
    page: all equal (every page starts a run of the same value), runs of
    rpp that cross every page boundary, alternating values, runs of two
    that start on and off a 16-byte pair, changes at, one before and one
    after a warp step's 64 values, random short runs; `signed` adds the
    int64 extremes and values that differ only in the top bit."""
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    rows = [np.full(n, 5), (i + rpp // 2) // rpp, i % 2, i // 2,
            (i + 1) // 2, i // 64, (i + 1) // 64, (i + 63) // 64,
            np.repeat(rng.integers(0, 3, size=n),
                      rng.integers(1, 5, size=n))[:n]]
    if signed:
        rows += [np.where(i % 2 == 1, I64_MIN, I64_MAX),
                 np.where((i // 64) % 2 == 1, I64_MIN, 0),
                 np.where(((i + 1) // 2) % 2 == 1, -1, I64_MAX)]
    cols = np.stack(rows).astype(np.int64)
    widths = np.resize(np.array([1, 2, 4, 8, 3], dtype=np.int64), len(rows))
    return cols, widths


def ns_edge_stack(n: int, signed: bool):
    """(cols, widths) of rows that hold NS's significant-byte edges
    2^(8k) - 1 and 2^(8k) (k = 1..7), 0, 1 and 2^63 - 1 at shifting
    positions, at every width 1-8 (where min(sig, w) caps), a row of
    255s (an odd half-byte sum where n is odd), and with `signed` -1,
    INT64_MIN and -2^(8k)."""
    edges = [0, 1, I64_MAX]
    for k in range(1, 8):
        edges += [(1 << (8 * k)) - 1, 1 << (8 * k)]
    if signed:
        edges += [-1, I64_MIN] + [-(1 << (8 * k)) for k in range(1, 8)]
    edges = np.array(edges, dtype=np.int64)
    rows = [np.resize(np.roll(edges, w), n) for w in range(1, 9)]
    rows.append(np.full(n, 255, dtype=np.int64))
    cols = np.stack(rows).astype(np.int64)
    widths = np.array(list(range(1, 9)) + [8], dtype=np.int64)
    return cols, widths


# ---------------------------------------------------------------------------
# GDICT's edge inputs (shared with the card tests): row lengths at the
# kernel's size classes +-1 -- a table in one block's shared memory up to
# 4,681 values, split over a cluster up to 74,898 (one block's share up to
# 9,362), in global memory beyond -- and the main path's 60,000
# ---------------------------------------------------------------------------

GDICT_EDGE_NS = (1, 2, 3, 4680, 4681, 4682, 9361, 9362, 9363, 60000, 74897,
                 74898, 74899)


def gdict_edge_stack(n: int, seed: int):
    """(cols, widths) of rows whose distinct values the GDICT hash set must
    count exactly: all equal; three distinct; all distinct; INT64_MIN (the
    empty-slot marker) among the int64 extremes, and the same row without
    it; all INT64_MIN; negatives; values that differ only in their high 32
    bits, or only in their low 32 bits; a small domain; the full range."""
    rng = np.random.default_rng(seed)
    ext = rng.choice([I64_MIN, I64_MAX, 0, -1, 1], size=n)
    ext[0] = I64_MIN
    rows = [np.full(n, 5),
            rng.choice([7, 1 << 20, 1 << 40], size=n),
            rng.permutation(n) * 7 + 3,
            ext, np.where(ext == I64_MIN, I64_MIN + 1, ext),
            np.full(n, I64_MIN),
            rng.integers(-(1 << 40), 0, size=n),
            rng.integers(0, max(2, n // 2), size=n) << 32,
            (5 << 32) | rng.integers(0, max(2, n // 2), size=n),
            rng.integers(0, 5, size=n),
            rng.integers(I64_MIN, I64_MAX, size=n, endpoint=True)]
    cols = np.stack(rows).astype(np.int64)
    widths = np.resize(np.array([1, 2, 4, 8, 3], dtype=np.int64), len(rows))
    return cols, widths


def port_model_config(cfg):
    """The port's ModelConfig equal to the JAX package's `cfg`, its MoE,
    hybrid and RWKV parts included."""
    import dataclasses

    from repro_torch.models import config as C
    d = dataclasses.asdict(cfg)
    for key, cls in (("moe", C.MoEConfig), ("hybrid", C.HybridConfig),
                     ("rwkv", C.RWKVConfig)):
        if d[key] is not None:
            d[key] = cls(**d[key])
    return C.ModelConfig(**d)


def carried_lm(cfg, seed: int = 0):
    """(the port's config, JAX `init_params(PRNGKey(seed), cfg)`, the
    port's CPU model carrying the same weights) for a JAX ModelConfig
    (JAX is imported here: the card-side tests import this module on a
    machine without it)."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro_torch.models import interop
    pc = port_model_config(cfg)
    jp = JM.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), pc,
                                   device="cpu")
    return pc, jp, tp


def midflight_tokens(engine_mod, params, cfg, midflight: bool, **kw):
    """Request 0's tokens from an engine module's `ServeEngine` (the JAX
    package's or the port's; `kw` goes to its constructor), alone or with
    request 1 admitted after two steps: `tests/test_serve_engine.py`'s
    mid-flight parity run."""
    eng = engine_mod.ServeEngine(cfg, params, engine_mod.EngineConfig(
        batch_slots=2, max_len=64), **kw)
    eng.submit(engine_mod.Request(uid=0, prompt=[5, 6, 7], max_new_tokens=5))
    if midflight:
        eng.step()
        eng.step()
        eng.submit(engine_mod.Request(uid=1, prompt=[9, 8, 4],
                                      max_new_tokens=5))
    eng.run_until_drained()
    return eng.finished[0].out_tokens


def port_key(k) -> "pt.NodeKey":
    return pt.NodeKey(k.table, tuple(k.cols), k.method)


def port_plan(ref) -> "pt.Plan":
    """A reference Plan in the port's types (the nodes in their order)."""
    from repro_torch.core.estimation_graph import Deduction, Node
    nodes = {}
    for k, n in ref.nodes.items():
        d = n.chosen
        chosen = None if d is None else Deduction(
            d.kind, tuple(port_key(c) for c in d.children),
            tuple(tuple(p) for p in d.parts))
        nodes[port_key(k)] = Node(port_key(k), pt.State(n.state.value),
                                  chosen,
                                  pt.errors.ErrorRV(n.rv.mean, n.rv.std),
                                  n.exact_bytes)
    return pt.Plan(ref.f, nodes, tuple(port_key(t) for t in ref.targets),
                   ref.total_cost, ref.feasible)


def assert_identical(got, ref, label=""):
    """`assert_plan_identical` against the reference's plan, and the same
    node order."""
    from repro_torch.core.planner_engine import assert_plan_identical
    want = port_plan(ref)
    assert_plan_identical(want, got, label)
    assert list(got.nodes) == list(want.nodes), label


PLAN_P_ATOL = 5e-5    # fused_score p against the reference (float32, its erf)


def assert_plans_match(got, want, e, exact_rv: bool):
    """The same f, total cost, feasibility, nodes and node states.  Each
    DEDUCED node with the same chosen deduction and error RVs within the
    fused_score tolerances (exactly equal where `exact_rv`), or else an
    equal-p tie: the float32 scorer (this port's and the JAX package's
    alike) breaks ties among candidates whose p agree to 1e-7 by its own
    roundings, which changes that node's deduction or, downstream, its
    children's RVs; the two RVs' p must then agree within the p
    tolerance.  Returns the number of such ties."""
    assert (got.f, got.total_cost, got.feasible) == \
        (want.f, want.total_cost, want.feasible)
    assert [k.label() for k in got.nodes] == [k.label() for k in want.nodes]
    ties = 0
    for kg, kw in zip(got.nodes, want.nodes):
        ng, nw = got.nodes[kg], want.nodes[kw]
        assert ng.state.value == nw.state.value, kg.label()
        assert (ng.chosen is None) == (nw.chosen is None)
        if exact_rv:
            assert (ng.rv.mean, ng.rv.std) == (nw.rv.mean, nw.rv.std)
            continue
        same = ng.chosen is None or \
            [c.label() for c in ng.chosen.children] == \
            [c.label() for c in nw.chosen.children]
        close = np.isclose(ng.rv.mean, nw.rv.mean, rtol=1e-5, atol=0.0) \
            and np.isclose(ng.rv.std, nw.rv.std, rtol=1e-4, atol=1e-6)
        if not (same and close):
            pg, pw = pt.errors.prob_within_batch(
                np.array([ng.rv.mean, nw.rv.mean]),
                np.array([ng.rv.std, nw.rv.std]), e)
            assert abs(pg - pw) <= PLAN_P_ATOL, kg.label()
            ties += 1
    return ties


EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
# wall times in the examples' output: "5.44s", "  31ms", "0.42 ms", "(1.2x)"
EXAMPLE_TIMES = re.compile(r"\d+(\.\d+)?\s*(s|ms)\b|\(\s*[\d.]+x\)")


def load_example(name):
    """examples/<name>.py as a module (the folder is not a package)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_output(fn, *args) -> str:
    """What fn(*args) prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def scorer_args(scorer: str, nq: int, m: int, ns: int, rng) -> list:
    """float32 operands of a greedy-step scorer ("sec": add a secondary,
    "rep": replace the clustered layout) whose paths mostly win through
    seek + RID (scan and covering costs 500-3000, RID terms of comparable
    size), so every rounding of the RID term and of the sum shows: nq
    queries, m candidates, ns kept secondaries."""
    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)
    q_w = u(0.1, 10, nq)
    ncols = rng.integers(1, 8, nq).astype(np.float32)
    if scorer == "rep":
        return [u(500, 3000, nq, m), u(500, 3000, nq, ns),
                u(0.01, 5, nq, ns), u(0, 300, nq, ns), u(1e5, 3e6, m),
                u(0, 0.3, m), ncols, q_w]
    return [u(500, 3000, nq), u(500, 3000, nq, m), u(0.01, 5, nq, m),
            u(0, 300, nq, m), np.float32(rng.uniform(1e5, 3e6)),
            np.float32(rng.uniform(0, 0.3)), ncols, q_w]


def f32_bits(a) -> np.ndarray:
    """float32 values as their int32 bit patterns, to compare bitwise."""
    return np.asarray(a, np.float32).view(np.int32)


def scorer_bits_differ(scorer: str, nq: int, m: int, ns: int, rng) -> int:
    """How many totals of a greedy-step scorer differ in bits between the
    port's torch scorer and the JAX package's, on `scorer_args` from
    `rng`."""
    import jax.numpy as jnp
    from repro.core import cost_engine as ref_ce
    from repro_torch.core import cost_engine as ce
    ours, ref = ((ce._score_secondary_torch, ref_ce._jax_score_secondary)
                 if scorer == "sec" else
                 (ce._score_replace_torch, ref_ce._jax_score_replace))
    args = scorer_args(scorer, nq, m, ns, rng)
    got = ours(*[torch.as_tensor(a) for a in args])
    want = ref(*[jnp.asarray(a) for a in args])
    return int((f32_bits(got.numpy()) != f32_bits(want)).sum())
