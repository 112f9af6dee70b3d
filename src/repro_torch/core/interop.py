"""Plain-data constructors for schemas and workloads.

They let a caller hand this package a schema and a workload built
elsewhere (for example by the JAX package, in a parity test) without
either package importing the other: tables travel as column definitions
plus NumPy arrays, statements as plain tuples.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

from .relation import ColumnDef, Predicate, Table
from .synopses import ForeignKey, Schema
from .workload import BulkInsert, Query, Statement, Workload

TableSpec = Tuple[Sequence[Tuple[str, int]], Mapping[str, np.ndarray]]


def schema_from_arrays(tables: Mapping[str, TableSpec],
                       fks: Iterable[Tuple[str, str, str, str]] = ()
                       ) -> Schema:
    """`tables` maps each table name to ([(column, width), ...],
    {column: values}); `fks` holds (fact_table, fk_col, dim_table,
    dim_key) tuples.  Table and column order are kept."""
    built: Dict[str, Table] = {}
    for name, (cols, values) in tables.items():
        built[name] = Table(name, [ColumnDef(c, int(w)) for c, w in cols],
                            {c: np.asarray(v) for c, v in values.items()})
    return Schema(built, [ForeignKey(*fk) for fk in fks])


def workload_from_spec(schema: Schema, statements: Iterable[tuple]
                       ) -> Workload:
    """Statements as plain tuples, in order:

    ("query", name, table, [(col, lo, hi), ...], [col, ...], weight)
    ("insert", name, table, nrows, weight)
    """
    out: List[Statement] = []
    for st in statements:
        kind = st[0]
        if kind == "query":
            _, name, table, filters, cols, weight = st
            out.append(Query(name, table,
                             tuple(Predicate(c, int(lo), int(hi))
                                   for c, lo, hi in filters),
                             tuple(cols), weight=float(weight)))
        elif kind == "insert":
            _, name, table, nrows, weight = st
            out.append(BulkInsert(name, table, int(nrows),
                                  weight=float(weight)))
        else:
            raise ValueError(f"unknown statement kind {kind!r}")
        if out[-1].table not in schema.tables:
            raise KeyError(f"statement {out[-1].name!r} references unknown "
                           f"table {out[-1].table!r}")
    return Workload(schema=schema, statements=out)
