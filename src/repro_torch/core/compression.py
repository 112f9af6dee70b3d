"""Compression methods (paper §2.1).

Five methods: NULL suppression (NS), global dictionary (GDICT), page-local
dictionary (LDICT), prefix suppression (PREFIX), run-length encoding (RLE).

NS and GDICT are order-INdependent (ORD-IND): the compressed size depends only
on the multiset of values.  LDICT, PREFIX and RLE are order-DEPENDENT
(ORD-DEP): the size depends on how values are distributed across pages, i.e.
on the index sort order (paper Figure 2).

All sizes are *payload bytes*; the cost model converts bytes -> pages.
Everything is vectorized NumPy so SampleCF and full-index sizing are cheap.

Each scalar kernel `_<m>_bytes(col, width, rpp)` has a batched twin
`<m>_bytes_batch(cols, widths, rpp)` operating on an (ntargets, nrows)
column stack — one row per (target, column) job, all rows sharing the same
rows-per-page — returning one payload-byte count per row.  The batched
kernels are exact integer re-expressions of the scalar ones (asserted
property-by-property in tests/test_core_compression.py) so the estimation
engine built on them is byte-identical to per-target SampleCF.

Backends (see repro_torch.core.backend): `batched_bytes(...,
backend="torch")` takes torch tensors and sizes all five methods through
the kernels of repro_torch.kernels.codec_bytes (hand-written CUDA on the
card, their plain PyTorch versions on the CPU), bit-identical to the NumPy
batch kernels here.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from ..kernels import codec_bytes as _ck
from .relation import ROW_OVERHEAD, rows_per_page

ORD_IND = "ORD-IND"
ORD_DEP = "ORD-DEP"

# per-page dictionary/metadata overhead for page-local methods
PAGE_META = 16


def significant_bytes(v: np.ndarray) -> np.ndarray:
    """Bytes needed to represent each value (leading zero bytes stripped)."""
    v = np.asarray(v, dtype=np.uint64)
    out = np.ones(v.shape, dtype=np.int64)
    for k in range(1, 8):
        out += (v >= np.uint64(1) << np.uint64(8 * k)).astype(np.int64)
    return out


def _pages(col: np.ndarray, rpp: int) -> np.ndarray:
    """Reshape a column (in index order) into (npages, rpp), edge-padded."""
    n = col.shape[0]
    npages = -(-n // rpp)
    pad = npages * rpp - n
    if pad:
        col = np.concatenate([col, np.repeat(col[-1], pad)])
    return col.reshape(npages, rpp), n


def _ptr_bytes(ndv) -> np.ndarray:
    """Bytes for a dictionary pointer addressing `ndv` entries."""
    ndv = np.asarray(ndv, dtype=np.int64)
    return np.where(ndv <= 256, 1, np.where(ndv <= 65536, 2, 3)).astype(np.int64)


# ---------------------------------------------------------------------------
# Per-column compressed sizes. data is (nrows, ncols) in index order.
# ---------------------------------------------------------------------------

def _ns_bytes(col: np.ndarray, width: int, rpp: int) -> int:
    # 4-bit length descriptor per value (SQL Server row-compression style),
    # never exceeding the uncompressed width.
    sig = np.minimum(significant_bytes(col), width)
    half_bytes = np.minimum(2 * sig + 1, 2 * width)
    return int((int(np.sum(half_bytes)) + 1) // 2)


def _gdict_bytes(col: np.ndarray, width: int, rpp: int) -> int:
    ndv = int(np.unique(col).size)
    ptr = int(_ptr_bytes(ndv))
    return ndv * width + col.shape[0] * ptr


def _ldict_bytes(col: np.ndarray, width: int, rpp: int) -> int:
    pages, n = _pages(col, rpp)
    srt = np.sort(pages, axis=1)
    ndv_p = 1 + np.count_nonzero(np.diff(srt, axis=1), axis=1)
    ptr = _ptr_bytes(ndv_p)
    # per-page: dictionary entries + per-row pointers (+ page metadata)
    rows_in_page = np.full(pages.shape[0], rpp, dtype=np.int64)
    if n % rpp:
        rows_in_page[-1] = n % rpp
    per_page = ndv_p * width + rows_in_page * ptr + PAGE_META
    cap = rows_in_page * width  # never bigger than uncompressed
    return int(np.sum(np.minimum(per_page, cap + PAGE_META)))


def _prefix_bytes(col: np.ndarray, width: int, rpp: int) -> int:
    pages, n = _pages(col, rpp)
    mn = pages.min(axis=1).astype(np.uint64)
    mx = pages.max(axis=1).astype(np.uint64)
    xor = mn ^ mx
    diff_bytes = np.where(xor == 0, 0, significant_bytes(xor))
    common = np.maximum(width - diff_bytes, 0)
    rows_in_page = np.full(pages.shape[0], rpp, dtype=np.int64)
    if n % rpp:
        rows_in_page[-1] = n % rpp
    # page stores the prefix once; rows store 1 marker + suffix bytes
    per_page = common + rows_in_page * (1 + width - common) + PAGE_META
    cap = rows_in_page * width
    return int(np.sum(np.minimum(per_page, cap + PAGE_META)))


def _rle_bytes(col: np.ndarray, width: int, rpp: int) -> int:
    pages, n = _pages(col, rpp)
    runs = 1 + np.count_nonzero(np.diff(pages, axis=1), axis=1)
    rows_in_page = np.full(pages.shape[0], rpp, dtype=np.int64)
    if n % rpp:
        rows_in_page[-1] = n % rpp
    per_page = runs * (width + 2) + PAGE_META  # value + 2-byte run length
    cap = rows_in_page * width
    return int(np.sum(np.minimum(per_page, cap + PAGE_META)))


# ---------------------------------------------------------------------------
# Batched per-method kernels.  cols is an (ntargets, nrows) stack — one row
# per (target, column) sizing job, every row in its target's index order —
# widths is (ntargets,), rpp is shared by the whole stack (the estimation
# engine groups jobs by rows-per-page).  Returns (ntargets,) payload bytes,
# exactly equal to applying the scalar kernel row by row.
# ---------------------------------------------------------------------------

def _rows_in_pages(n: int, rpp: int) -> np.ndarray:
    """Rows actually stored in each of the ceil(n/rpp) pages."""
    npages = -(-n // rpp)
    rows = np.full(npages, rpp, dtype=np.int64)
    if n % rpp:
        rows[-1] = n % rpp
    return rows


def _pages_batch(cols: np.ndarray, rpp: int) -> np.ndarray:
    """(m, n) -> (m, npages, rpp), each row edge-padded with its last value."""
    m, n = cols.shape
    npages = -(-n // rpp)
    pad = npages * rpp - n
    if pad:
        cols = np.concatenate([cols, np.repeat(cols[:, -1:], pad, axis=1)],
                              axis=1)
    return cols.reshape(m, npages, rpp)


def _batch_io(cols, widths) -> tuple:
    cols = np.asarray(cols, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64)
    return cols, widths


def ns_bytes_batch(cols: np.ndarray, widths: np.ndarray,
                   rpp: int) -> np.ndarray:
    cols, widths = _batch_io(cols, widths)
    if cols.shape[1] == 0:
        return np.zeros(cols.shape[0], dtype=np.int64)
    sig = np.minimum(significant_bytes(cols), widths[:, None])
    half_bytes = np.minimum(2 * sig + 1, 2 * widths[:, None])
    return (half_bytes.sum(axis=1) + 1) // 2


def gdict_bytes_batch(cols: np.ndarray, widths: np.ndarray,
                      rpp: int) -> np.ndarray:
    cols, widths = _batch_io(cols, widths)
    m, n = cols.shape
    if n == 0:
        return np.zeros(m, dtype=np.int64)
    srt = np.sort(cols, axis=1)
    ndv = 1 + np.count_nonzero(np.diff(srt, axis=1), axis=1)
    return ndv * widths + n * _ptr_bytes(ndv)


def ldict_bytes_batch(cols: np.ndarray, widths: np.ndarray,
                      rpp: int) -> np.ndarray:
    cols, widths = _batch_io(cols, widths)
    m, n = cols.shape
    if n == 0:
        return np.zeros(m, dtype=np.int64)
    pages = _pages_batch(cols, rpp)
    srt = np.sort(pages, axis=2)
    ndv_p = 1 + np.count_nonzero(np.diff(srt, axis=2), axis=2)  # (m, npages)
    rows = _rows_in_pages(n, rpp)[None, :]
    w = widths[:, None]
    per_page = ndv_p * w + rows * _ptr_bytes(ndv_p) + PAGE_META
    cap = rows * w
    return np.minimum(per_page, cap + PAGE_META).sum(axis=1)


def prefix_bytes_batch(cols: np.ndarray, widths: np.ndarray,
                       rpp: int) -> np.ndarray:
    cols, widths = _batch_io(cols, widths)
    m, n = cols.shape
    if n == 0:
        return np.zeros(m, dtype=np.int64)
    pages = _pages_batch(cols, rpp)
    mn = pages.min(axis=2).astype(np.uint64)
    mx = pages.max(axis=2).astype(np.uint64)
    xor = mn ^ mx
    diff_bytes = np.where(xor == 0, 0, significant_bytes(xor))
    rows = _rows_in_pages(n, rpp)[None, :]
    w = widths[:, None]
    common = np.maximum(w - diff_bytes, 0)
    per_page = common + rows * (1 + w - common) + PAGE_META
    cap = rows * w
    return np.minimum(per_page, cap + PAGE_META).sum(axis=1)


def rle_bytes_batch(cols: np.ndarray, widths: np.ndarray,
                    rpp: int) -> np.ndarray:
    cols, widths = _batch_io(cols, widths)
    m, n = cols.shape
    if n == 0:
        return np.zeros(m, dtype=np.int64)
    pages = _pages_batch(cols, rpp)
    runs = 1 + np.count_nonzero(np.diff(pages, axis=2), axis=2)
    rows = _rows_in_pages(n, rpp)[None, :]
    w = widths[:, None]
    per_page = runs * (w + 2) + PAGE_META
    cap = rows * w
    return np.minimum(per_page, cap + PAGE_META).sum(axis=1)


BATCH_KERNELS: Dict[str, Callable[[np.ndarray, np.ndarray, int], np.ndarray]] \
    = {
    "NS": ns_bytes_batch,
    "GDICT": gdict_bytes_batch,
    "LDICT": ldict_bytes_batch,
    "PREFIX": prefix_bytes_batch,
    "RLE": rle_bytes_batch,
}


def batched_bytes(method: str, cols, widths, rpp: int,
                  backend: str = "numpy"):
    """Per-row payload bytes of `method` over an (ntargets, nrows) stack.

    backend="numpy": NumPy arrays in, an int64 array out.  backend="torch":
    int64 torch tensors in, an int64 tensor on their device out."""
    if backend == "numpy":
        return BATCH_KERNELS[method](cols, widths, rpp)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    if method == "NS":
        return _ck.ns_bytes(cols, widths)
    if method == "GDICT":
        return _ck.gdict_bytes(cols, widths)
    paged = {"LDICT": _ck.ldict_bytes, "PREFIX": _ck.prefix_bytes,
             "RLE": _ck.rle_bytes}
    return paged[method](cols, widths, rpp)


class Method:
    def __init__(self, name: str, kind: str,
                 fn: Callable[[np.ndarray, int, int], int],
                 alpha: float, beta: float):
        self.name = name
        self.kind = kind          # ORD_IND or ORD_DEP
        self._fn = fn
        # cost-model constants (paper App. A): alpha = CPU to compress one
        # tuple on update; beta = CPU to decompress one column of one tuple.
        self.alpha = alpha
        self.beta = beta

    @property
    def order_dependent(self) -> bool:
        return self.kind == ORD_DEP

    def compressed_bytes(self, data: np.ndarray, widths: Sequence[int]) -> int:
        """Payload bytes of the compressed index (data in index order)."""
        rw = int(sum(widths))
        rpp = rows_per_page(rw)
        total = data.shape[0] * ROW_OVERHEAD
        for j, w in enumerate(widths):
            total += self._fn(data[:, j], int(w), rpp)
        return int(total)


# alpha/beta loosely follow the paper's ROW-vs-PAGE ordering: page-local
# methods cost more CPU than row methods (App. A; [13] microbenchmarks).
METHODS: Dict[str, Method] = {
    "NS":     Method("NS", ORD_IND, _ns_bytes, alpha=1.0, beta=0.20),
    "GDICT":  Method("GDICT", ORD_IND, _gdict_bytes, alpha=1.5, beta=0.25),
    "LDICT":  Method("LDICT", ORD_DEP, _ldict_bytes, alpha=2.5, beta=0.45),
    "PREFIX": Method("PREFIX", ORD_DEP, _prefix_bytes, alpha=2.0, beta=0.35),
    "RLE":    Method("RLE", ORD_DEP, _rle_bytes, alpha=1.8, beta=0.30),
}

# The two "packages" the advisor offers by default, mirroring SQL Server's
# ROW (null suppression) and PAGE (local dictionary) compression.
DEFAULT_ADVISOR_METHODS = ("NS", "LDICT")


def uncompressed_payload_bytes(nrows: int, widths: Sequence[int]) -> int:
    return nrows * (int(sum(widths)) + ROW_OVERHEAD)


def compressed_payload_bytes(method: str, data: np.ndarray,
                             widths: Sequence[int]) -> int:
    return METHODS[method].compressed_bytes(data, widths)
