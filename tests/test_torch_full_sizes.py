"""Full-index ground truth (`samplecf.full_index_sizes`, the truth of the
paper's Fig. 9) of the port against the JAX package's: the integer bytes
`==` the reference's in NumPy and through the torch route (each built
column a one-row stack through the codec wrappers, their plain versions
on the CPU), partial and empty indexes included; the `full_index_sizes`
cases of the reference's compression tests; GDICT's layout for a
6,000,000-value row."""
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core.samplecf import full_index_sizes as ref_full
from repro_torch.core import compression as C
from repro_torch.core.relation import ColumnDef, IndexDef, Predicate, Table
from repro_torch.core.samplecf import compressed_index_bytes, \
    full_index_sizes
from repro_torch.kernels import codec_bytes as cb
from torch_port_util import port_schema

CPU = torch.device("cpu")
METHODS = ("NS", "GDICT", "LDICT", "PREFIX", "RLE")
ALL_COLS = ("l_shipdate", "l_returnflag", "l_extendedprice", "l_quantity")
INDEXES = [("l_shipdate",), ("l_returnflag",), ("l_shipdate", "l_returnflag"),
           ALL_COLS, ("l_quantity", "l_discount"), ("l_orderkey",),
           ("l_shipmode", "l_shipdate"), ("l_suppkey", "l_partkey", "l_tax")]


@pytest.fixture(scope="module")
def ref_schema():
    return rc.make_tpch_like(scale=0.5, z=0, seed=0)


@pytest.fixture(scope="module")
def lineitem(ref_schema):
    return port_schema(ref_schema).tables["lineitem"]


@pytest.mark.parametrize("method", METHODS + (None,))
@pytest.mark.parametrize("cols", INDEXES, ids="-".join)
def test_full_index_sizes_equal_reference(ref_schema, lineitem, method,
                                          cols):
    want = ref_full(ref_schema.tables["lineitem"],
                    rc.IndexDef("lineitem", cols, compression=method))
    idx = IndexDef("lineitem", cols, compression=method)
    assert full_index_sizes(lineitem, idx) == want
    assert full_index_sizes(lineitem, idx, CPU) == want


@pytest.mark.parametrize("method", METHODS)
def test_partial_and_empty_indexes_equal_reference(ref_schema, lineitem,
                                                   method):
    lo, hi = lineitem.minmax("l_shipdate")
    for p_lo, p_hi in ((lo, (lo + hi) // 3), (hi + 1, hi + 5)):
        idx = IndexDef("lineitem", ("l_shipdate", "l_quantity"), method,
                       predicate=Predicate("l_shipdate", p_lo, p_hi))
        want = ref_full(ref_schema.tables["lineitem"], rc.IndexDef(
            "lineitem", ("l_shipdate", "l_quantity"), method,
            predicate=rc.Predicate("l_shipdate", p_lo, p_hi)))
        assert full_index_sizes(lineitem, idx) == want
        assert full_index_sizes(lineitem, idx, CPU) == want


@pytest.mark.parametrize("method", METHODS)
def test_device_route_goes_through_the_wrappers(lineitem, method,
                                                monkeypatch):
    """Each built column is one (1, nrows) stack through its codec's
    wrapper on the device route, and NumPy alone without a device."""
    name = {"NS": "ns_bytes", "GDICT": "gdict_bytes", "LDICT": "ldict_bytes",
            "PREFIX": "prefix_bytes", "RLE": "rle_bytes"}[method]
    shapes = []
    orig = getattr(cb, name)

    def counting(cols, *a, **kw):
        shapes.append(tuple(cols.shape))
        return orig(cols, *a, **kw)
    monkeypatch.setattr(cb, name, counting)
    idx = IndexDef("lineitem", ("l_shipdate", "l_returnflag"), method)
    full_index_sizes(lineitem, idx)
    assert shapes == []
    full_index_sizes(lineitem, idx, CPU)
    assert shapes == [(1, lineitem.nrows)] * 2


@pytest.mark.parametrize("method", METHODS)
def test_cf_at_most_one_plus_meta(lineitem, method):
    idx = IndexDef("lineitem", ALL_COLS, compression=method)
    s, sc = full_index_sizes(lineitem, idx, CPU)
    # per-page metadata can push slightly above 1 only for PAGE methods
    assert sc <= s * 1.02


@pytest.mark.parametrize("method", ["NS", "GDICT"])
def test_ord_ind_order_invariance(lineitem, method):
    """ORD-IND: same column SET => same compressed size (Figure 2)."""
    a = IndexDef("lineitem", ("l_shipdate", "l_returnflag"), method)
    b = IndexDef("lineitem", ("l_returnflag", "l_shipdate"), method)
    assert full_index_sizes(lineitem, a, CPU)[1] == \
        full_index_sizes(lineitem, b, CPU)[1]


def test_ord_dep_order_matters():
    """ORD-DEP methods are sensitive to key order (Figure 2): LDICT and
    RLE prefer OPPOSITE orders on the same data."""
    rng = np.random.default_rng(0)
    t = Table("t", [ColumnDef("a", 4), ColumnDef("b", 4)], {
        "a": rng.integers(0, 5, 30000),       # low cardinality
        "b": rng.integers(0, 5000, 30000)})   # high cardinality
    sizes = {}
    for method in ("LDICT", "RLE"):
        for cols in (("a", "b"), ("b", "a")):
            idx = IndexDef("t", cols, compression=method)
            sizes[(method, cols)] = full_index_sizes(t, idx, CPU)[1]
            assert sizes[(method, cols)] == full_index_sizes(t, idx)[1]
    assert sizes[("LDICT", ("b", "a"))] < sizes[("LDICT", ("a", "b"))]
    assert sizes[("RLE", ("a", "b"))] < sizes[("RLE", ("b", "a"))]


def test_ns_unbiased_small_values():
    t = Table("t", [ColumnDef("a", 8)], {"a": np.arange(1000) % 7})
    idx = IndexDef("t", ("a",), compression="NS")
    s, sc = full_index_sizes(t, idx, CPU)
    assert sc < 0.5 * s  # 8-byte width, tiny values => big NS win


@pytest.mark.parametrize("seed", range(3))
def test_compressed_index_bytes_on_random_tables(seed):
    """Random widths, signs and int64 extremes: the torch route `==` the
    NumPy formula for every method."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    widths = [int(w) for w in rng.integers(1, 9, 3)]
    data = np.stack([rng.integers(-(1 << 40), 1 << 40, n),
                     rng.integers(0, 7, n),
                     rng.choice([-(1 << 63), (1 << 63) - 1, 0], n)], axis=1)
    for method in METHODS:
        assert compressed_index_bytes(data, widths, method, CPU) == \
            C.compressed_payload_bytes(method, data, widths)


def test_gdict_layout_for_an_sf1_lineitem_row():
    """A 6,000,000-value row (TPC-H SF1's lineitem) takes the global
    layout: one table of 2^24 slots, 134,217,728 B of scratch."""
    plan = cb.gdict_plan(1, 6_000_000, 132)
    assert (plan.route, plan.log_slots, plan.tables) == ("global", 24, 1)
    assert plan.scratch_bytes == 134_217_728
