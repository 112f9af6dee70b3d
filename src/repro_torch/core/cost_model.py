"""Compression-aware what-if cost model (paper Appendix A).

    CPUCost_update = BaseCPUCost + alpha * #tuples_written
    CPUCost_read   = BaseCPUCost + beta  * #tuples_read * #columns_read

alpha/beta are per-method constants (larger for PAGE-style methods).  Only
columns actually used by the query are decompressed (A.2).  The I/O model is
unchanged — compression helps purely through the smaller (estimated) size.

Cost unit is abstract "milliseconds"; constants are calibrated so sequential
I/O dominates large scans (the regime the paper targets).

Every cost function is ufunc-safe: the numeric arguments may be scalars or
NumPy arrays of any broadcastable shape, and the result has the broadcast
shape.  The batched cost engine (repro_torch.core.cost_engine) relies on this to
score an entire candidate pool per greedy step in a handful of vectorized
ops.  `compression` stays a scalar method name (or None); callers whose
elements mix methods (RID lookups into mixed base layouts, a statement row
appended across every registered index) pass precomputed per-element
`alpha_coef` / `beta_coef` arrays instead.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from .compression import METHODS
from .relation import PAGE_BYTES

ArrayLike = Union[float, np.ndarray]

# elementary constants (ms).  Calibrated to the paper's hardware (App. D.1:
# 10K RPM HDD + dual-core CPU): sequential 8KB page ~0.08ms (100MB/s), random
# page ~5ms (seek+rotate), per-tuple predicate CPU ~50ns.  Large scans are
# I/O-bound — the regime where compression pays — while decompression CPU
# (beta) and compression-on-write CPU (alpha) can flip the trade-off for
# CPU-bound or update-heavy statements, as in the paper's Examples 1-2.
T_IO_SEQ = 0.08         # per sequential page read/write
T_IO_RAND = 5.0         # per random page access (RID lookup)
CPU_ROW = 0.00005       # base CPU per tuple touched
ALPHA_UNIT = 0.0002     # scales Method.alpha  (compress one tuple)
BETA_UNIT = 0.00002     # scales Method.beta   (decompress one column value)
INDEX_MAINT_CPU = 0.0005  # per tuple B-tree maintenance on insert
SEEK_OVERHEAD = 1.0     # root-to-leaf traversal (upper levels mostly cached)


def pages_of(size_bytes: ArrayLike) -> ArrayLike:
    return np.maximum(size_bytes, 0.0) / PAGE_BYTES


def alpha(method: str) -> float:
    return METHODS[method].alpha * ALPHA_UNIT


def beta(method: str) -> float:
    return METHODS[method].beta * BETA_UNIT


def alpha_coef_of(compression: Optional[str]) -> float:
    """Per-tuple compress-on-write CPU coefficient (0 when uncompressed)."""
    return 0.0 if compression is None else alpha(compression)


def beta_coef_of(compression: Optional[str]) -> float:
    """Per-column-value decompression CPU coefficient (0 when uncompressed)."""
    return 0.0 if compression is None else beta(compression)


def scan_cost(size_bytes: ArrayLike, nrows: ArrayLike, ncols_used: ArrayLike,
              compression: Optional[str] = None, *,
              beta_coef: Optional[ArrayLike] = None) -> ArrayLike:
    """Sequential scan of `size_bytes` touching `nrows` tuples."""
    if beta_coef is None:
        beta_coef = beta_coef_of(compression)
    io = T_IO_SEQ * pages_of(size_bytes)
    cpu = CPU_ROW * nrows + beta_coef * nrows * ncols_used   # A.2
    return io + cpu


def seek_cost(size_bytes: ArrayLike, nrows_index: ArrayLike,
              selectivity: ArrayLike, ncols_used: ArrayLike,
              compression: Optional[str] = None, *,
              beta_coef: Optional[ArrayLike] = None) -> ArrayLike:
    """Range seek reading a `selectivity` fraction of the index."""
    if beta_coef is None:
        beta_coef = beta_coef_of(compression)
    rows = nrows_index * selectivity
    io = SEEK_OVERHEAD + T_IO_SEQ * pages_of(size_bytes * selectivity)
    cpu = CPU_ROW * rows + beta_coef * rows * ncols_used
    return io + cpu


def rid_lookup_cost(nrows: ArrayLike, base_size_bytes: ArrayLike, *,
                    ncols_used: ArrayLike, beta_coef: ArrayLike) -> ArrayLike:
    """Random lookups into the base layout for a non-covering index path;
    `beta_coef` is the base layout's decompression coefficient."""
    npages = pages_of(base_size_bytes)
    touched = np.minimum(nrows, npages)  # cap: can't touch more pages than exist
    io = T_IO_RAND * touched
    cpu = CPU_ROW * nrows + beta_coef * nrows * ncols_used
    return io + cpu


def update_cost(index_size_bytes: ArrayLike, index_nrows: ArrayLike,
                rows_written: ArrayLike,
                compression: Optional[str] = None, *,
                alpha_coef: Optional[ArrayLike] = None) -> ArrayLike:
    """Bulk-insert maintenance cost for ONE index (A.1)."""
    if alpha_coef is None:
        alpha_coef = alpha_coef_of(compression)
    frac_written = np.where(
        np.asarray(index_nrows) <= 0, 1.0,
        np.minimum(rows_written / np.maximum(index_nrows, 1e-300), 1.0))
    io = T_IO_SEQ * pages_of(index_size_bytes * frac_written)
    cpu = (CPU_ROW + INDEX_MAINT_CPU) * rows_written
    cpu = cpu + alpha_coef * rows_written     # A.1
    return io + cpu
