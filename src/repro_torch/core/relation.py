"""Columnar relation substrate for the faithful paper reproduction.

The paper operates on tables, (composite, ordered) indexes, and a page model.
We mirror that with integer-valued NumPy columns (strings/dates are encoded as
ints; a column carries a logical byte *width* used by every compression method
and by the page model).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

PAGE_BYTES = 8192
# Per-row bookkeeping overhead (slot array entry + record header), as in
# SQL Server's page layout. Kept small and constant.
ROW_OVERHEAD = 4


@dataclasses.dataclass(frozen=True)
class ColumnDef:
    name: str
    width: int  # logical fixed byte width (1..8)

    def __post_init__(self):
        if not (1 <= self.width <= 8):
            raise ValueError(f"column width must be in [1,8], got {self.width}")


class Table:
    """An in-memory columnar table.

    values[c] is an int64 array; each column has a fixed logical byte width.
    """

    def __init__(self, name: str, columns: Sequence[ColumnDef],
                 values: Mapping[str, np.ndarray]):
        self.name = name
        self.columns: Tuple[ColumnDef, ...] = tuple(columns)
        self.col_by_name = {c.name: c for c in self.columns}
        if set(values) != {c.name for c in self.columns}:
            raise ValueError("values keys must match column defs")
        n = None
        self.values = {}
        for c in self.columns:
            v = np.asarray(values[c.name], dtype=np.int64)
            if n is None:
                n = v.shape[0]
            elif v.shape[0] != n:
                raise ValueError("ragged columns")
            maxv = int(v.max(initial=0))
            minv = int(v.min(initial=0))
            if minv < 0:
                raise ValueError(f"column {c.name}: negative values unsupported")
            if maxv >= (1 << (8 * c.width)):
                raise ValueError(f"column {c.name}: value exceeds width {c.width}")
            self.values[c.name] = v
        self.nrows = int(n or 0)
        self._stats_cache: dict = {}

    # ---- statistics the "query optimizer" maintains (paper §2.2) ----
    def ndv(self, cols: Sequence[str]) -> int:
        """Number of distinct value combinations of `cols` (cached)."""
        key = ("ndv", tuple(cols))
        if key not in self._stats_cache:
            if len(cols) == 1:
                n = int(np.unique(self.values[cols[0]]).size)
            else:
                stacked = np.stack([self.values[c] for c in cols], axis=1)
                n = int(np.unique(stacked, axis=0).shape[0])
            self._stats_cache[key] = n
        return self._stats_cache[key]

    def minmax(self, col: str) -> Tuple[int, int]:
        key = ("minmax", col)
        if key not in self._stats_cache:
            v = self.values[col]
            self._stats_cache[key] = (int(v.min()), int(v.max()))
        return self._stats_cache[key]

    def width_of(self, cols: Sequence[str]) -> int:
        """Summed byte width of `cols`."""
        return sum(self.col_by_name[c].width for c in cols)

    def take(self, rows: np.ndarray, name: Optional[str] = None) -> "Table":
        vals = {c.name: self.values[c.name][rows] for c in self.columns}
        return Table(name or f"{self.name}#sample", self.columns, vals)


@dataclasses.dataclass(frozen=True)
class Predicate:
    """Range predicate lo <= col <= hi (equality when lo == hi)."""
    col: str
    lo: int
    hi: int

    def mask(self, table: Table) -> np.ndarray:
        v = table.values[self.col]
        return (v >= self.lo) & (v <= self.hi)

    def selectivity(self, table: Table) -> float:
        """Optimizer-style estimate from min/max stats (uniform assumption)."""
        mn, mx = table.minmax(self.col)
        if mx <= mn:
            return 1.0
        frac = (min(self.hi, mx) - max(self.lo, mn) + 1) / (mx - mn + 1)
        return float(min(1.0, max(0.0, frac)))


@dataclasses.dataclass(frozen=True)
class IndexDef:
    """A (possibly partial) ordered composite index.

    `cols` is the full ordered column list stored in the index (key columns
    first).  `compression` is None (uncompressed) or a method name registered
    in repro_torch.core.compression.  `clustered` marks the table's primary layout.
    """
    table: str
    cols: Tuple[str, ...]
    compression: Optional[str] = None
    clustered: bool = False
    predicate: Optional[Predicate] = None  # partial index

    @property
    def key(self) -> Tuple:
        return (self.table, self.cols, self.compression, self.clustered,
                self.predicate)

    def uncompressed(self) -> "IndexDef":
        return dataclasses.replace(self, compression=None)

    def with_compression(self, method: Optional[str]) -> "IndexDef":
        return dataclasses.replace(self, compression=method)

    def label(self) -> str:
        c = f"^{self.compression}" if self.compression else ""
        p = f"|{self.predicate.col}" if self.predicate else ""
        cl = "*" if self.clustered else ""
        return f"{self.table}({','.join(self.cols)}){c}{p}{cl}"


def rows_per_page(row_width: int) -> int:
    return max(1, PAGE_BYTES // (row_width + ROW_OVERHEAD))


def build_index_data(table: Table, idx: IndexDef) -> np.ndarray:
    """Materialize index rows: filter (partial), sort by key cols.

    Returns an (nrows, ncols) int64 matrix in index order.
    """
    if idx.predicate is not None:
        rows = np.nonzero(idx.predicate.mask(table))[0]
        sub = {c: table.values[c][rows] for c in idx.cols}
    else:
        sub = {c: table.values[c] for c in idx.cols}
    # lexicographic sort by key columns (np.lexsort: last key is primary)
    keys = [sub[c] for c in reversed(idx.cols)]
    order = np.lexsort(keys) if keys else np.arange(table.nrows)
    return np.stack([sub[c][order] for c in idx.cols], axis=1)


def uncompressed_bytes(nrows: int, widths: Sequence[int]) -> int:
    """Size of an uncompressed index with the page model."""
    rw = sum(widths)
    rpp = rows_per_page(rw)
    npages = -(-nrows // rpp) if nrows else 0
    return npages * PAGE_BYTES


def uncompressed_pages(nrows: int, widths: Sequence[int]) -> int:
    rw = sum(widths)
    rpp = rows_per_page(rw)
    return -(-nrows // rpp) if nrows else 0
