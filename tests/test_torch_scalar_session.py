"""The port's statement-at-a-time paths in the online session, and the
reference's helpers that nothing else calls, against the JAX package.

* `AdvisorSession` with the `use_*` switches off: after a delta the
  session recommends `==` a fresh `DesignAdvisor` with the same options
  (twin of `tests/test_session.py::test_scalar_path_session_parity`), on
  numpy and torch-CPU, and `==` the reference's session bit for bit; in
  compressed mode the inner sessions get `_inner_options()`.
* `staged_recommend(use_engine=False)` (twin of
  `test_staged_scalar_engine_close_to_batched`).
* `make_scaled_workload_reference` field by field against the
  reference's, and its structure against `make_scaled_workload` (twin of
  `tests/test_workload_compression.py::test_structurally_equivalent_to_
  reference`).
* `Table.width_of`, `IndexDef.uncompressed`, `relation.uncompressed_bytes`
  and `kernels.quantize_blockwise.quantize_kv` against the reference's.
* A switch moves only its own phase: with `use_engine=False` on
  `device="cpu"` the torch planner and estimation engines still run (their
  plain versions are called) and no `CostEngine` is built."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import relation as ref_rel
from repro.core.advisor import staged_recommend as ref_staged
from repro.kernels import ref as ref_kernels
import repro_torch.core as pt
from repro_torch.core import relation as rel
from repro_torch.kernels import codec_bytes as cb
from repro_torch.kernels import planner_score as ps
from repro_torch.kernels import quantize_blockwise as qb
from torch_port_util import (labels, port_schema, port_workload,
                             statement_spec)

ROUTES = [dict(backend="numpy"), dict(device="cpu")]
ROUTE_IDS = ["numpy", "torch-cpu"]
ALL_OFF = dict(use_engine=False, use_batched_planner=False,
               use_batched_estimation=False)


@pytest.fixture(scope="module")
def ref_schema():
    return rc.make_tpch_like(scale=0.15, z=0, seed=0)


@pytest.fixture(scope="module")
def schema(ref_schema):
    return port_schema(ref_schema)


@pytest.fixture(scope="module")
def base_size(schema):
    wl = pt.make_scaled_workload(schema, n_statements=40, seed=2)
    adv = pt.DesignAdvisor(wl, pt.AdvisorOptions(backend="numpy"))
    return sum(adv.sizes.size(i)
               for i in pt.base_configuration(schema).indexes)


def assert_identical(rec_s, rec_f):
    assert rec_s.config == rec_f.config
    assert rec_s.cost == rec_f.cost
    assert rec_s.used_bytes == rec_f.used_bytes
    assert rec_s.base_cost == rec_f.base_cost
    assert rec_s.n_sampled == rec_f.n_sampled
    assert rec_s.n_deduced == rec_f.n_deduced
    assert rec_s.estimation_cost_pages == rec_f.estimation_cost_pages
    assert rec_s.pool_size == rec_f.pool_size
    assert rec_s.candidate_count == rec_f.candidate_count


def assert_same_as_reference(rec, ref):
    assert labels(rec.config) == labels(ref.config)
    assert (rec.cost, rec.used_bytes, rec.base_cost) == \
        (ref.cost, ref.used_bytes, ref.base_cost)
    assert rec.steps == ref.steps


def _delta(pkg, wl, schema):
    """test_scalar_path_session_parity's delta in package `pkg`."""
    drift = [dataclasses.replace(s, name=f"x{i}") for i, s in
             enumerate(pkg.make_scaled_workload(schema, n_statements=6,
                                                seed=8).statements)]
    return pkg.WorkloadDelta(added=tuple(drift[:2]),
                             removed=(wl.statements[1].name,),
                             reweighted=((wl.statements[0].name, 3.0),))


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_scalar_path_session_parity(ref_schema, schema, base_size, route):
    """Twin of test_scalar_path_session_parity: all three switches off,
    the session after a delta (2 added, 1 removed, 1 reweighted) ==
    a fresh DesignAdvisor; each round == the reference's session's, bit
    for bit (every phase runs the same float64 host code on the same
    integer sizes)."""
    ref_wl = rc.make_scaled_workload(ref_schema, n_statements=12, seed=4)
    wl = port_workload(ref_wl, schema)
    opt = pt.AdvisorOptions(**ALL_OFF, **route)
    sess = pt.AdvisorSession(wl, opt)
    assert sess.engine is None and not sess.planner.use_engine
    ref_sess = rc.AdvisorSession(ref_wl, rc.AdvisorOptions(**ALL_OFF))
    budget = 0.3 * base_size
    assert_same_as_reference(sess.recommend(budget),
                             ref_sess.recommend(budget))
    delta = _delta(pt, wl, schema)
    wl2 = wl.apply_delta(delta)
    sess.apply(delta)
    ref_sess.apply(_delta(rc, ref_wl, ref_schema))
    assert [statement_spec(s) for s in sess.workload.statements] == \
        [statement_spec(s) for s in ref_sess.workload.statements]
    rec = sess.recommend(budget)
    assert_identical(rec, pt.DesignAdvisor(wl2, opt).recommend(budget))
    assert_same_as_reference(rec, ref_sess.recommend(budget))
    assert sess.peek_cost_jobs() == []
    assert "engine_rows_added" not in sess.stats


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_compressed_session_inner_options(schema, base_size, route):
    """In compressed mode the inner sessions take `_inner_options()`: the
    outer's switches, uncompressed; the session == a fresh advisor with
    the same options before and after a delta."""
    wl = pt.make_scaled_workload(schema, n_statements=40, seed=2)
    opt = pt.AdvisorOptions(use_engine=False, compression_budget=8, **route)
    sess = pt.AdvisorSession(wl, opt)
    inner = sess._inner_options()
    assert inner == dataclasses.replace(opt, compression_budget=None)
    assert not inner.use_engine and inner.use_batched_planner
    budget = 0.3 * base_size
    assert_identical(sess.recommend(budget),
                     pt.DesignAdvisor(wl, opt).recommend(budget))
    assert sess._inner.opt == inner and sess._inner.engine is None
    delta = _delta(pt, wl, schema)
    sess.apply(delta)
    assert_identical(sess.recommend(budget), pt.DesignAdvisor(
        wl.apply_delta(delta), opt).recommend(budget))


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_staged_scalar_engine_close_to_batched(ref_schema, schema,
                                               base_size, route):
    """Twin of test_staged_scalar_engine_close_to_batched on the session
    tests' workload; the scalar staged run == the reference's."""
    ref_wl = rc.make_scaled_workload(ref_schema, n_statements=40, seed=2)
    wl = port_workload(ref_wl, schema)
    b = 0.3 * base_size
    rec_b = pt.staged_recommend(wl, b, options=pt.AdvisorOptions(**route))
    rec_s = pt.staged_recommend(wl, b, options=pt.AdvisorOptions(
        use_engine=False, **route))
    assert rec_b.config == rec_s.config
    assert abs(rec_b.cost - rec_s.cost) <= 1e-6 * max(rec_s.cost, 1.0)
    ref = ref_staged(ref_wl, b, options=rc.AdvisorOptions(use_engine=False))
    assert labels(rec_s.config) == labels(ref.config)
    assert (rec_s.cost, rec_s.used_bytes) == (ref.cost, ref.used_bytes)


# ---------------------------------------------------------------------------
# make_scaled_workload_reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_scaled_workload_reference_equals_reference(ref_schema, schema,
                                                    seed):
    """The same statements as the reference's generator, field by field
    (the same draws in the same order), and the same structure as the
    batched `make_scaled_workload` (twin of
    test_structurally_equivalent_to_reference)."""
    ref = rc.make_scaled_workload_reference(ref_schema, n_statements=200,
                                            seed=seed)
    got = pt.make_scaled_workload_reference(schema, n_statements=200,
                                            seed=seed)
    assert [statement_spec(s) for s in got.statements] == \
        [statement_spec(s) for s in ref.statements]
    assert [type(s).__name__ for s in got.statements] == \
        [type(s).__name__ for s in ref.statements]
    new = pt.make_scaled_workload(schema, n_statements=200, seed=seed)
    assert [s.name for s in new.statements] == \
        [s.name for s in got.statements]
    assert [type(s) for s in new.statements] == \
        [type(s) for s in got.statements]
    for s in got.statements:
        t = schema.tables[s.table]
        if isinstance(s, pt.BulkInsert):
            assert s.nrows == max(t.nrows // 50, 50)
            continue
        names = {c.name for c in t.columns}
        assert 1 <= len(s.filters) <= 3
        fcols = [p.col for p in s.filters]
        assert len(set(fcols)) == len(fcols)
        for p in s.filters:
            mn, mx = t.minmax(p.col)
            assert mn <= p.lo <= p.hi <= mx
        assert 1 <= len(s.cols_used) <= 4
        assert set(s.cols_used) <= names
        assert 0.5 <= s.weight <= 2.0


# ---------------------------------------------------------------------------
# the reference's helpers that nothing calls
# ---------------------------------------------------------------------------

def test_relation_helpers_equal_reference(ref_schema, schema):
    for name, t in schema.tables.items():
        cols = [c.name for c in t.columns]
        for k in range(len(cols) + 1):
            assert t.width_of(cols[:k]) == \
                ref_schema.tables[name].width_of(cols[:k])
    idx = rel.IndexDef("lineitem", ("l_shipdate", "l_quantity"), "LDICT",
                       True, rel.Predicate("l_shipdate", 3, 9))
    assert idx.uncompressed() == dataclasses.replace(idx, compression=None)
    ref_idx = ref_rel.IndexDef("lineitem", ("l_shipdate", "l_quantity"),
                               "LDICT", True,
                               ref_rel.Predicate("l_shipdate", 3, 9))
    assert idx.uncompressed().label() == ref_idx.uncompressed().label()
    r = np.random.default_rng(7)
    for n in [0, 1, 2, 272, 273, 274, 6_000_000] + \
            [int(x) for x in r.integers(0, 10**7, 20)]:
        for widths in ([4], [8, 4], [1, 2, 8, 8], [25] * 6, [4096]):
            got = rel.uncompressed_bytes(n, widths)
            assert got == ref_rel.uncompressed_bytes(n, widths)
            assert got == rel.uncompressed_pages(n, widths) * rel.PAGE_BYTES


@pytest.mark.parametrize("shape,block", [((2, 16, 4, 64), 128),
                                         ((3, 4, 64), 32), ((5, 100), 128)])
def test_quantize_kv_equals_reference(shape, block):
    """quantize_kv on the CPU (the plain version) == the reference's
    quantize_kv, bit for bit: TinyLlama-1.1B's KV layout (4 KV heads of
    64, one masked block of 128 a head row), a block below the head
    dimension, a ragged row."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x[0, ..., :3] = 0.0
    q, s = qb.quantize_kv(torch.from_numpy(x), block)
    rq, rs = ref_kernels.quantize_kv(x, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    pq, ps_ = qb.quantize_blockwise_plain(torch.from_numpy(x), block)
    assert torch.equal(q, pq) and torch.equal(s, ps_)


# ---------------------------------------------------------------------------
# a switch moves only its own phase
# ---------------------------------------------------------------------------

def test_switch_moves_only_its_phase(schema, base_size, monkeypatch):
    """With `use_engine=False` on device="cpu", the torch planner and
    estimation engines are still built and used: the walk's and the codec
    kernels' plain versions are called, and no CostEngine is built; with
    the two estimation switches off as well, none of them is called."""
    calls = {"walk": 0, "codec": 0, "cost_engine": 0}

    def counting(fn, what):
        def wrapper(*a, **kw):
            calls[what] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(ps, "planner_walk_plain",
                        counting(ps.planner_walk_plain, "walk"))
    for name in ("ns_bytes_plain", "ldict_bytes_plain"):
        monkeypatch.setattr(cb, name, counting(getattr(cb, name), "codec"))
    from repro_torch.core import advisor, session
    for mod in (advisor, session):
        monkeypatch.setattr(mod, "CostEngine",
                            counting(mod.CostEngine, "cost_engine"))
    wl = pt.make_scaled_workload(schema, n_statements=40, seed=2)
    budget = 0.3 * base_size
    opt = pt.AdvisorOptions(device="cpu", use_engine=False)
    rec = pt.DesignAdvisor(wl, opt).recommend(budget)
    assert calls["walk"] == 1 and calls["codec"] > 0
    assert calls["cost_engine"] == 0
    sess = pt.AdvisorSession(wl, opt)
    assert sess.est_engine.device == torch.device("cpu")
    assert sess.planner.engine.device == torch.device("cpu")
    assert_identical(sess.recommend(budget), rec)
    assert calls["walk"] == 2 and calls["cost_engine"] == 0
    for k in calls:
        calls[k] = 0
    pt.DesignAdvisor(wl, pt.AdvisorOptions(device="cpu", **ALL_OFF)) \
        .recommend(budget)
    assert calls == {"walk": 0, "codec": 0, "cost_engine": 0}
