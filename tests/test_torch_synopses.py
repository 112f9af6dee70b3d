"""The port's join synopses, filtered samples and MV samples
(`repro_torch.core.synopses`) against the JAX package's on the same
schema and sample seed: every sample row, every MV group and count,
`n_est` and every `mv_index_size` estimate `==` the reference's, in NumPy
(`device` None) and through the torch route on the CPU (the codec
wrappers' plain versions), and the reference tests' assertions."""
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core.synopses import MVDef as RefMV, SynopsisManager as RefSyn
import repro_torch.core as pt
from repro_torch.core import synopses as syn_mod
from repro_torch.core.relation import Predicate
from torch_port_util import port_schema

F = 0.05
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref_schema():
    return rc.make_tpch_like(scale=0.5, z=0, seed=0)


@pytest.fixture(scope="module")
def schema(ref_schema):
    return port_schema(ref_schema)


def managers(ref_schema, schema, seed=0):
    ref = RefSyn(ref_schema, rc.SampleManager(ref_schema.tables, seed=seed))
    port = pt.SynopsisManager(schema, pt.SampleManager(schema.tables,
                                                       seed=seed))
    port_dev = pt.SynopsisManager(schema, pt.SampleManager(schema.tables,
                                                           seed=seed),
                                  device=CPU)
    return ref, port, port_dev


def assert_tables_equal(got, want):
    assert got.name == want.name
    assert [(c.name, c.width) for c in got.columns] == \
        [(c.name, c.width) for c in want.columns]
    for c in want.columns:
        np.testing.assert_array_equal(got.values[c.name],
                                      want.values[c.name])


def fk_of(schema, fact, dim):
    return next(fk for fk in schema.fks_of(fact) if fk.dim_table == dim)


def test_fks_of_equal_reference(ref_schema, schema):
    for fact in ("lineitem", "orders", "part"):
        assert [(k.fact_table, k.fk_col, k.dim_table, k.dim_key)
                for k in schema.fks_of(fact)] == \
            [(k.fact_table, k.fk_col, k.dim_table, k.dim_key)
             for k in ref_schema.fks_of(fact)]


@pytest.mark.parametrize("fact", ["lineitem", "orders"])
@pytest.mark.parametrize("f", [0.01, 0.05])
def test_join_synopsis_equals_reference(ref_schema, schema, fact, f):
    ref, port, _ = managers(ref_schema, schema)
    assert_tables_equal(port.join_synopsis(fact, f),
                        ref.join_synopsis(fact, f))


def test_join_sample_with_dims_inner_join_equals_reference(ref_schema,
                                                           schema):
    """A sample whose foreign keys miss some dimension rows: the
    unmatched rows drop out (inner join), as in the reference."""
    base = schema.tables["lineitem"].take(np.arange(0, 3000, 7))
    ref_base = ref_schema.tables["lineitem"].take(np.arange(0, 3000, 7))
    orders = schema.tables["orders"]
    keep = np.nonzero(orders.values["o_orderkey"] % 3 != 0)[0]
    small = pt.Schema({**schema.tables, "orders": orders.take(keep)},
                      schema.foreign_keys)
    ref_orders = ref_schema.tables["orders"]
    ref_small = rc.Schema({**ref_schema.tables,
                           "orders": ref_orders.take(keep)},
                          ref_schema.foreign_keys)
    got = syn_mod.join_sample_with_dims(base, small,
                                        (fk_of(small, "lineitem", "orders"),))
    want = rc.synopses.join_sample_with_dims(
        ref_base, ref_small, (fk_of(ref_small, "lineitem", "orders"),))
    assert got.nrows < base.nrows
    assert_tables_equal(got, want)


def test_filtered_sample_equals_reference(ref_schema, schema):
    ref, port, _ = managers(ref_schema, schema)
    lo, hi = schema.tables["lineitem"].minmax("l_shipdate")
    mid = (lo + hi) // 2
    got = port.filtered_sample("lineitem", Predicate("l_shipdate", lo, mid),
                               F)
    want = ref.filtered_sample("lineitem",
                               rc.Predicate("l_shipdate", lo, mid), F)
    assert got.nrows > 0 and got.values["l_shipdate"].max() <= mid
    assert_tables_equal(got, want)


MVS = [("lineitem", (), ("l_shipdate",), False, None),
       ("lineitem", (), ("l_shipdate", "l_returnflag"), False, None),
       ("orders", (), ("o_orderdate", "o_orderpriority"), False, None),
       ("lineitem", ("o_orderpriority", "l_shipmode"),
        ("o_orderpriority", "l_shipmode"), True, None),
       ("lineitem", ("l_suppkey",), ("l_suppkey",), False, "l_quantity"),
       ("lineitem", ("l_shipdate", "l_extendedprice"), (), False, None),
       ("lineitem", ("l_shipdate", "o_orderdate"), (), True, "l_discount")]


def mv_pair(ref_schema, schema, tbl, cols, group_by, join, pred_col):
    name = f"mv_{tbl}_{'_'.join(group_by or cols)}"
    pred = ref_pred = None
    if pred_col is not None:
        lo, hi = schema.tables[tbl].minmax(pred_col)
        pred = Predicate(pred_col, lo, (lo + hi) // 2)
        ref_pred = rc.Predicate(pred_col, lo, (lo + hi) // 2)
    joins = (fk_of(schema, tbl, "orders"),) if join else ()
    ref_joins = (fk_of(ref_schema, tbl, "orders"),) if join else ()
    port = pt.MVDef(name, tbl, joins=joins, cols=cols, predicate=pred,
                    group_by=group_by)
    ref = RefMV(name, tbl, joins=ref_joins, cols=cols, predicate=ref_pred,
                group_by=group_by)
    return port, ref


@pytest.mark.parametrize("spec", MVS, ids=lambda s: "_".join(s[2] or s[1]))
def test_mv_sample_equals_reference(ref_schema, schema, spec):
    ref, port, port_dev = managers(ref_schema, schema)
    mv, ref_mv = mv_pair(ref_schema, schema, *spec)
    smv_r, n_r = ref.mv_sample(ref_mv, F)
    for syn in (port, port_dev):
        smv, n_est = syn.mv_sample(mv, F)
        assert n_est == n_r
        assert_tables_equal(smv, smv_r)


@pytest.mark.parametrize("method", ["NS", "GDICT", "LDICT", "PREFIX", "RLE",
                                    None])
@pytest.mark.parametrize("spec", MVS[:5], ids=lambda s: "_".join(s[2]))
def test_mv_index_size_equals_reference(ref_schema, schema, spec, method):
    """numpy and the torch route (CPU) == the reference, every field."""
    ref, port, port_dev = managers(ref_schema, schema)
    mv, ref_mv = mv_pair(ref_schema, schema, *spec)
    cols = spec[2]
    want = ref.mv_index_size(ref_mv, cols, method, F)
    for syn in (port, port_dev):
        got = syn.mv_index_size(mv, cols, method, F)
        assert (got.est_bytes, got.cf, got.cost_pages, got.method) == \
            (want.est_bytes, want.cf, want.cost_pages, want.method)
        assert got.index.label() == want.index.label()


def test_mv_index_size_on_the_device_route_runs_the_codec_wrappers(
        ref_schema, schema, monkeypatch):
    """With a device the MV index's codecs go through the kernel wrappers
    (their plain versions on the CPU); without, through NumPy."""
    from repro_torch.kernels import codec_bytes as cb
    calls = []
    orig = cb.ldict_bytes

    def counting(*a, **kw):
        calls.append(a[0].device)
        return orig(*a, **kw)
    monkeypatch.setattr(cb, "ldict_bytes", counting)
    _, port, port_dev = managers(ref_schema, schema)
    mv = pt.MVDef("mv_big", "lineitem",
                  group_by=("l_partkey", "l_suppkey"))
    port.mv_index_size(mv, ("l_partkey", "l_suppkey"), "LDICT", 0.5)
    assert calls == []
    port_dev.mv_index_size(mv, ("l_partkey", "l_suppkey"), "LDICT", 0.5)
    assert calls and all(d == CPU for d in calls)


def test_join_synopsis_fk_match(schema):
    samples = pt.SampleManager(schema.tables, seed=0)
    syn = pt.SynopsisManager(schema, samples)
    js = syn.join_synopsis("lineitem", 0.05)
    base = samples.get_sample("lineitem", 0.05)
    assert js.nrows == base.nrows  # FKs always match (B.2)
    assert "o_orderdate" in js.values  # dimension columns joined in
