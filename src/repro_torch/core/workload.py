"""Workload model + TPC-H-like synthetic generator (paper §7 / App. D.2).

Statements are single-table analytic SELECTs (range/equality filters +
aggregated columns) and bulk-load INSERTs, with weights that skew the mix
SELECT-intensive or INSERT-intensive exactly as in the paper's experiments.

`make_tpch_like`, `make_scaled_workload` and its statement-at-a-time
reference `make_scaled_workload_reference` draw from the same NumPy
generator in the same order as the JAX package's, so equal arguments give
equal data and statements.  A `WorkloadDelta` (the online session's unit
of change) turns a workload into the one a fresh advisor would be given:
removals drop, reweights apply in place, additions append.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

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


@dataclasses.dataclass(frozen=True)
class WorkloadDelta:
    """One batch of workload mutations (the online-session delta unit).

    Statement *names* are the stable ids: `added` appends new statements
    (their names must be fresh), `removed` drops statements by name, and
    `reweighted` replaces the weight of existing statements in place.
    Survivors keep their relative order and additions go to the end --
    exactly how `Workload.apply_delta` builds the resulting workload a
    fresh advisor would be given.
    """
    added: Tuple[Statement, ...] = ()
    removed: Tuple[str, ...] = ()
    reweighted: Tuple[Tuple[str, float], ...] = ()

    def __bool__(self) -> bool:
        return bool(self.added or self.removed or self.reweighted)


@dataclasses.dataclass
class Workload:
    schema: Schema
    statements: List[Statement]

    def queries(self) -> List[Query]:
        return [s for s in self.statements if isinstance(s, Query)]

    def updates(self) -> List[BulkInsert]:
        return [s for s in self.statements if isinstance(s, BulkInsert)]

    # -- delta API (stable statement ids = names) -----------------------
    def by_name(self) -> Dict[str, Statement]:
        out: Dict[str, Statement] = {}
        for s in self.statements:
            if s.name in out:
                raise ValueError(f"duplicate statement name {s.name!r}")
            out[s.name] = s
        return out

    def apply_delta(self, delta: WorkloadDelta) -> "Workload":
        """The resulting workload after `delta` (functional; `self` is
        untouched).  Everything is validated before anything is built, so
        a bad delta raises KeyError or ValueError and changes nothing."""
        have = self.by_name()
        for name in delta.removed:
            if name not in have:
                raise KeyError(f"cannot remove unknown statement {name!r}")
        removed = set(delta.removed)
        reweight: Dict[str, float] = {}
        for name, w in delta.reweighted:
            if name not in have:
                raise KeyError(f"cannot reweight unknown statement {name!r}")
            if name in removed:
                raise ValueError(f"statement {name!r} both removed and "
                                 "reweighted in one delta")
            reweight[name] = float(w)
        seen_add = set()
        for s in delta.added:
            if s.name in have or s.name in seen_add:
                raise ValueError(f"added statement name {s.name!r} is not "
                                 "fresh")
            seen_add.add(s.name)
            if s.table not in self.schema.tables:
                raise KeyError(f"added statement {s.name!r} references "
                               f"unknown table {s.table!r}")
        stmts: List[Statement] = []
        for s in self.statements:
            if s.name in removed:
                continue
            w = reweight.get(s.name)
            stmts.append(s if w is None
                         else dataclasses.replace(s, weight=w))
        stmts.extend(delta.added)
        return Workload(schema=self.schema, statements=stmts)


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


def make_scaled_workload_reference(schema: Schema, n_statements: int = 200,
                                   insert_fraction: float = 0.1, seed: int = 0,
                                   insert_weight: float = 0.1) -> Workload:
    """The statement-at-a-time generator (one rng call per draw, per
    statement), the behavioural reference for `make_scaled_workload`: the
    same draw ranges and branch probabilities, the same statement names
    and query / insert split, but the draws land in another stream order,
    so individual statements differ for the same seed.  Its draws are the
    JAX package's reference generator's, in its order, so equal arguments
    give equal statements.  Too slow beyond a few thousand statements.
    """
    rng = np.random.default_rng(seed)
    tables = list(schema.tables.values())
    # weight table choice by row count: fact tables dominate, like TPC-H
    p = np.array([t.nrows for t in tables], dtype=np.float64)
    p /= p.sum()
    n_inserts = int(round(n_statements * insert_fraction))
    n_queries = n_statements - n_inserts
    stmts: List[Statement] = []
    for k in range(n_queries):
        t = tables[int(rng.choice(len(tables), p=p))]
        cols = [c.name for c in t.columns]
        nf = int(rng.integers(1, min(3, len(cols)) + 1))
        fcols = list(rng.choice(len(cols), size=nf, replace=False))
        filters = []
        for ci in fcols:
            name = cols[int(ci)]
            mn, mx = t.minmax(name)
            if mx <= mn or rng.random() < 0.25:      # equality predicate
                v = int(rng.integers(mn, mx + 1))
                filters.append(Predicate(name, v, v))
            else:                                    # range predicate
                frac = float(rng.uniform(0.01, 0.6))
                lo = int(rng.integers(mn, max(mn, int(mx - (mx - mn) * frac))
                                      + 1))
                hi = min(mx, lo + max(1, int((mx - mn) * frac)))
                filters.append(Predicate(name, lo, hi))
        rest = [c for c in cols if c not in {f.col for f in filters}]
        nu = int(rng.integers(1, min(4, max(1, len(rest))) + 1))
        used = [rest[int(i)] for i in
                rng.choice(len(rest), size=min(nu, len(rest)),
                           replace=False)] if rest else [filters[0].col]
        stmts.append(Query(f"s{k:04d}", t.name, tuple(filters), tuple(used),
                           weight=float(rng.uniform(0.5, 2.0))))
    for k in range(n_inserts):
        t = tables[int(rng.choice(len(tables), p=p))]
        stmts.append(BulkInsert(f"ins{k:03d}", t.name,
                                max(t.nrows // 50, 50),
                                weight=insert_weight))
    return Workload(schema=schema, statements=stmts)


def make_scaled_workload(schema: Schema, n_statements: int = 200,
                         insert_fraction: float = 0.1, seed: int = 0,
                         insert_weight: float = 0.1) -> Workload:
    """Synthetic workload with an arbitrary statement count (advisor-scaling
    experiments, paper §7's 'large workload' regime).

    Random single-table analytic SELECTs — 1-3 range/equality filters over
    random columns, 1-4 projected columns, mixed selectivities — plus an
    `insert_fraction` share of bulk loads.  Deterministic in `seed`: the
    same batched sequence of NumPy draws as the JAX package's generator,
    so equal arguments give equal statements, predicates and weights.

    All random draws are batched into a fixed sequence of array-shaped rng
    calls (one per draw *kind*, not per statement); the per-statement loop
    below only assembles Query objects from precomputed arrays.
    """
    rng = np.random.default_rng(seed)
    tables = list(schema.tables.values())
    # weight table choice by row count: fact tables dominate, like TPC-H
    p = np.array([t.nrows for t in tables], dtype=np.float64)
    p /= p.sum()
    n_inserts = int(round(n_statements * insert_fraction))
    n_queries = n_statements - n_inserts

    ncols = np.array([len(t.columns) for t in tables], dtype=np.int64)
    maxc = int(ncols.max())
    colnames = [[c.name for c in t.columns] for t in tables]
    mn_tab = np.zeros((len(tables), maxc), dtype=np.int64)
    mx_tab = np.zeros((len(tables), maxc), dtype=np.int64)
    for a, t in enumerate(tables):
        for j, c in enumerate(t.columns):
            mn, mx = t.minmax(c.name)
            mn_tab[a, j], mx_tab[a, j] = int(mn), int(mx)

    MAXF = 3
    ti = rng.choice(len(tables), size=n_queries, p=p)
    tc = ncols[ti]
    nf = 1 + np.floor(rng.random(n_queries)
                      * np.minimum(MAXF, tc)).astype(np.int64)
    # filter-column choice without replacement: random sort keys per row,
    # slots beyond the table's column count pushed past every valid slot
    invalid = np.arange(maxc)[None, :] >= tc[:, None]
    fkeys = rng.random((n_queries, maxc))
    fkeys[invalid] = np.inf
    forder = np.argsort(fkeys, axis=1, kind="stable")
    eq_u = rng.random((n_queries, MAXF))
    val_u = rng.random((n_queries, MAXF))
    frac = 0.01 + 0.59 * rng.random((n_queries, MAXF))
    lo_u = rng.random((n_queries, MAXF))
    # projected-column choice: fresh keys with the chosen filter slots
    # (and invalid slots) masked out, so projection never repeats a filter
    pkeys = rng.random((n_queries, maxc))
    pkeys[invalid] = np.inf
    if n_queries:
        rows = np.repeat(np.arange(n_queries), MAXF)
        slot = np.tile(np.arange(MAXF), n_queries)
        taken = slot < nf[rows]
        pkeys[rows[taken], forder[:, :MAXF].ravel()[taken]] = np.inf
    porder = np.argsort(pkeys, axis=1, kind="stable")
    nrest = tc - nf
    nu = 1 + np.floor(rng.random(n_queries)
                      * np.minimum(4, np.maximum(1, nrest))).astype(np.int64)
    nu = np.minimum(nu, nrest)
    weights = 0.5 + 1.5 * rng.random(n_queries)
    ti_ins = rng.choice(len(tables), size=n_inserts, p=p)

    # convert once to plain Python containers — per-element numpy scalar
    # boxing inside the assembly loop dominates otherwise
    ti_l, nf_l, nu_l = ti.tolist(), nf.tolist(), nu.tolist()
    forder_l, porder_l = forder[:, :maxc].tolist(), porder.tolist()
    eq_l, val_l = eq_u.tolist(), val_u.tolist()
    frac_l, lo_l, w_l = frac.tolist(), lo_u.tolist(), weights.tolist()
    mn_l, mx_l = mn_tab.tolist(), mx_tab.tolist()
    tnames = [t.name for t in tables]

    stmts: List[Statement] = []
    for k in range(n_queries):
        a = ti_l[k]
        names = colnames[a]
        mns, mxs = mn_l[a], mx_l[a]
        fo, eqr, valr, fracr, lor = (forder_l[k], eq_l[k], val_l[k],
                                     frac_l[k], lo_l[k])
        filters = []
        for j in range(nf_l[k]):
            ci = fo[j]
            mn, mx = mns[ci], mxs[ci]
            if mx <= mn or eqr[j] < 0.25:            # equality predicate
                v = mn + int(valr[j] * (mx - mn + 1))
                filters.append(Predicate(names[ci], v, v))
            else:                                    # range predicate
                f = fracr[j]
                top = max(mn, int(mx - (mx - mn) * f))
                lo = mn + int(lor[j] * (top - mn + 1))
                hi = min(mx, lo + max(1, int((mx - mn) * f)))
                filters.append(Predicate(names[ci], lo, hi))
        nuk = nu_l[k]
        if nuk > 0:
            po = porder_l[k]
            used = tuple(names[po[j]] for j in range(nuk))
        else:                                        # every column filtered
            used = (filters[0].col,)
        stmts.append(Query(f"s{k:04d}", tnames[a], tuple(filters),
                           used, weight=w_l[k]))
    ins_l = ti_ins.tolist()
    for k in range(n_inserts):
        t = tables[ins_l[k]]
        stmts.append(BulkInsert(f"ins{k:03d}", t.name,
                                max(t.nrows // 50, 50),
                                weight=insert_weight))
    return Workload(schema=schema, statements=stmts)
