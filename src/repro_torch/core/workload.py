"""Workload model + TPC-H-like synthetic generator (paper §7 / App. D.2).

Statements are single-table analytic SELECTs (range/equality filters +
aggregated columns) and bulk-load INSERTs, with weights that skew the mix
SELECT-intensive or INSERT-intensive exactly as in the paper's experiments.

`make_tpch_like` draws from the same NumPy generator in the same order as
the JAX package's, so equal (scale, z, seed) give equal arrays.  Workload
deltas and the scaled synthetic generators are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

import numpy as np

from .relation import ColumnDef, Predicate, Table
from .synopses import ForeignKey, Schema


@dataclasses.dataclass(frozen=True)
class Query:
    name: str
    table: str
    filters: Tuple[Predicate, ...]
    cols_used: Tuple[str, ...]  # projected / aggregated columns
    weight: float = 1.0

    def all_cols(self) -> Tuple[str, ...]:
        seen = dict.fromkeys([p.col for p in self.filters])
        seen.update(dict.fromkeys(self.cols_used))
        return tuple(seen)


@dataclasses.dataclass(frozen=True)
class BulkInsert:
    name: str
    table: str
    nrows: int
    weight: float = 1.0


Statement = Union[Query, BulkInsert]


@dataclasses.dataclass
class Workload:
    schema: Schema
    statements: List[Statement]

    def queries(self) -> List[Query]:
        return [s for s in self.statements if isinstance(s, Query)]

    def updates(self) -> List[BulkInsert]:
        return [s for s in self.statements if isinstance(s, BulkInsert)]


# ---------------------------------------------------------------------------
# Synthetic TPC-H-like data
# ---------------------------------------------------------------------------

def _zipf_choice(rng: np.random.Generator, n_distinct: int, size: int,
                 z: float) -> np.ndarray:
    if z <= 0:
        return rng.integers(0, n_distinct, size=size)
    ranks = np.arange(1, n_distinct + 1, dtype=np.float64)
    p = ranks ** (-z)
    p /= p.sum()
    return rng.choice(n_distinct, size=size, p=p)


def make_tpch_like(scale: float = 1.0, z: float = 0.0, seed: int = 0) -> Schema:
    """A miniature TPC-H-shaped schema; `scale`=1 => 60k lineitem rows."""
    rng = np.random.default_rng(seed)
    n_li = max(int(60_000 * scale), 1000)
    n_ord = max(n_li // 4, 100)
    n_part = max(n_li // 30, 50)
    n_supp = max(n_li // 150, 10)
    n_cust = max(n_ord // 10, 20)

    date_lo, n_dates = 728_000, 2_400  # ~6.5 years of day numbers

    orders = Table("orders", [
        ColumnDef("o_orderkey", 4), ColumnDef("o_custkey", 4),
        ColumnDef("o_orderstatus", 1), ColumnDef("o_totalprice", 4),
        ColumnDef("o_orderdate", 4), ColumnDef("o_orderpriority", 1),
        ColumnDef("o_clerk", 2),
    ], {
        "o_orderkey": np.arange(n_ord),
        "o_custkey": _zipf_choice(rng, n_cust, n_ord, z),
        "o_orderstatus": _zipf_choice(rng, 3, n_ord, z),
        "o_totalprice": rng.integers(1_000, 500_000, n_ord),
        "o_orderdate": date_lo + _zipf_choice(rng, n_dates, n_ord, z),
        "o_orderpriority": _zipf_choice(rng, 5, n_ord, z),
        "o_clerk": _zipf_choice(rng, 1000, n_ord, z),
    })

    li_orderkey = rng.integers(0, n_ord, n_li)
    li_shipdate = (orders.values["o_orderdate"][li_orderkey]
                   + rng.integers(1, 120, n_li))
    lineitem = Table("lineitem", [
        ColumnDef("l_orderkey", 4), ColumnDef("l_partkey", 4),
        ColumnDef("l_suppkey", 4), ColumnDef("l_quantity", 1),
        ColumnDef("l_extendedprice", 4), ColumnDef("l_discount", 1),
        ColumnDef("l_tax", 1), ColumnDef("l_returnflag", 1),
        ColumnDef("l_linestatus", 1), ColumnDef("l_shipdate", 4),
        ColumnDef("l_shipmode", 1),
    ], {
        "l_orderkey": li_orderkey,
        "l_partkey": _zipf_choice(rng, n_part, n_li, z),
        "l_suppkey": _zipf_choice(rng, n_supp, n_li, z),
        "l_quantity": 1 + _zipf_choice(rng, 50, n_li, z),
        "l_extendedprice": rng.integers(100, 100_000, n_li),
        "l_discount": _zipf_choice(rng, 11, n_li, z),
        "l_tax": _zipf_choice(rng, 9, n_li, z),
        "l_returnflag": _zipf_choice(rng, 3, n_li, z),
        "l_linestatus": _zipf_choice(rng, 2, n_li, z),
        "l_shipdate": li_shipdate,
        "l_shipmode": _zipf_choice(rng, 7, n_li, z),
    })

    part = Table("part", [
        ColumnDef("p_partkey", 4), ColumnDef("p_brand", 1),
        ColumnDef("p_type", 1), ColumnDef("p_size", 1),
        ColumnDef("p_container", 1), ColumnDef("p_retailprice", 4),
    ], {
        "p_partkey": np.arange(n_part),
        "p_brand": _zipf_choice(rng, 25, n_part, z),
        "p_type": _zipf_choice(rng, 150, n_part, z) % 256,
        "p_size": 1 + _zipf_choice(rng, 50, n_part, z),
        "p_container": _zipf_choice(rng, 40, n_part, z),
        "p_retailprice": rng.integers(900, 2_000, n_part),
    })

    supplier = Table("supplier", [
        ColumnDef("s_suppkey", 4), ColumnDef("s_nationkey", 1),
        ColumnDef("s_acctbal", 4),
    ], {
        "s_suppkey": np.arange(n_supp),
        "s_nationkey": _zipf_choice(rng, 25, n_supp, z),
        "s_acctbal": rng.integers(0, 100_000, n_supp),
    })

    customer = Table("customer", [
        ColumnDef("c_custkey", 4), ColumnDef("c_nationkey", 1),
        ColumnDef("c_mktsegment", 1), ColumnDef("c_acctbal", 4),
    ], {
        "c_custkey": np.arange(n_cust),
        "c_nationkey": _zipf_choice(rng, 25, n_cust, z),
        "c_mktsegment": _zipf_choice(rng, 5, n_cust, z),
        "c_acctbal": rng.integers(0, 100_000, n_cust),
    })

    fks = [
        ForeignKey("lineitem", "l_orderkey", "orders", "o_orderkey"),
        ForeignKey("lineitem", "l_partkey", "part", "p_partkey"),
        ForeignKey("lineitem", "l_suppkey", "supplier", "s_suppkey"),
        ForeignKey("orders", "o_custkey", "customer", "c_custkey"),
    ]
    return Schema({t.name: t for t in
                   (lineitem, orders, part, supplier, customer)}, fks)


def make_tpch_workload(schema: Schema, insert_weight: float = 0.1,
                       query_weight: float = 1.0) -> Workload:
    """~20 analytic queries + 2 bulk loads, TPC-H-flavored (App. D.2).

    insert_weight 0.1 => SELECT-intensive; 20 => INSERT-intensive.
    """
    li = schema.tables["lineitem"]
    od = schema.tables["orders"]
    dlo, dhi = li.minmax("l_shipdate")
    olo, ohi = od.minmax("o_orderdate")
    span = dhi - dlo
    ospan = ohi - olo

    def drange(frac_lo: float, frac_hi: float) -> Tuple[int, int]:
        return (int(dlo + span * frac_lo), int(dlo + span * frac_hi))

    P = Predicate
    qs: List[Statement] = []

    def q(name, table, filters, cols):
        qs.append(Query(name, table, tuple(filters), tuple(cols),
                        weight=query_weight))

    # pricing summary (Q1-like): wide scan, small date filter
    a, b = drange(0.0, 0.9)
    q("q01", "lineitem", [P("l_shipdate", a, b)],
      ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
       "l_discount", "l_tax"])
    # revenue in a year with discount/quantity bands (Q6-like)
    a, b = drange(0.3, 0.45)
    q("q06", "lineitem", [P("l_shipdate", a, b), P("l_discount", 5, 7),
                          P("l_quantity", 1, 24)],
      ["l_extendedprice", "l_discount"])
    # shipping modes (Q12-like)
    a, b = drange(0.5, 0.65)
    q("q12", "lineitem", [P("l_shipdate", a, b), P("l_shipmode", 2, 3)],
      ["l_orderkey", "l_shipmode"])
    # narrow selective seek
    a, b = drange(0.70, 0.72)
    q("q03", "lineitem", [P("l_shipdate", a, b)],
      ["l_orderkey", "l_extendedprice", "l_discount"])
    a, b = drange(0.10, 0.13)
    q("q04", "lineitem", [P("l_shipdate", a, b), P("l_returnflag", 1, 1)],
      ["l_extendedprice", "l_suppkey"])
    q("q05", "lineitem", [P("l_suppkey", 0, max(2, li.minmax("l_suppkey")[1] // 20))],
      ["l_extendedprice", "l_discount", "l_shipdate"])
    q("q07", "lineitem", [P("l_returnflag", 2, 2)],
      ["l_extendedprice", "l_quantity"])
    q("q08", "lineitem", [P("l_shipmode", 5, 6)],
      ["l_extendedprice", "l_shipdate"])
    a, b = drange(0.2, 0.8)
    q("q09", "lineitem", [P("l_shipdate", a, b), P("l_tax", 0, 2)],
      ["l_partkey", "l_extendedprice"])
    q("q10", "lineitem", [P("l_quantity", 40, 50)],
      ["l_extendedprice", "l_discount", "l_partkey"])
    a, b = drange(0.55, 0.60)
    q("q11", "lineitem", [P("l_shipdate", a, b)],
      ["l_suppkey", "l_quantity", "l_extendedprice"])
    q("q14", "lineitem", [P("l_partkey", 0, max(2, li.minmax("l_partkey")[1] // 10))],
      ["l_extendedprice", "l_discount", "l_shipdate"])

    def orange(fl, fh):
        return (int(olo + ospan * fl), int(olo + ospan * fh))

    a, b = orange(0.4, 0.55)
    q("q21", "orders", [P("o_orderdate", a, b)],
      ["o_totalprice", "o_orderpriority"])
    a, b = orange(0.8, 1.0)
    q("q22", "orders", [P("o_orderdate", a, b), P("o_orderstatus", 0, 0)],
      ["o_totalprice", "o_custkey"])
    q("q23", "orders", [P("o_orderpriority", 0, 1)],
      ["o_totalprice", "o_orderdate"])
    a, b = orange(0.1, 0.12)
    q("q24", "orders", [P("o_orderdate", a, b)],
      ["o_custkey", "o_totalprice", "o_clerk"])
    q("q25", "orders", [P("o_custkey", 0, max(2, od.minmax("o_custkey")[1] // 15))],
      ["o_totalprice", "o_orderdate"])
    q("q26", "customer", [P("c_mktsegment", 1, 1)],
      ["c_custkey", "c_acctbal"])
    q("q27", "part", [P("p_brand", 3, 4), P("p_size", 10, 20)],
      ["p_partkey", "p_retailprice"])
    q("q28", "part", [P("p_container", 7, 9)],
      ["p_retailprice", "p_size"])

    # two bulk loads on fact tables (App. D.2)
    qs.append(BulkInsert("load_lineitem", "lineitem",
                         max(li.nrows // 50, 100), weight=insert_weight))
    qs.append(BulkInsert("load_orders", "orders",
                         max(od.nrows // 50, 50), weight=insert_weight))
    return Workload(schema=schema, statements=qs)
