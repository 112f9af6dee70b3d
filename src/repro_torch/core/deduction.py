"""Size deduction for compressed indexes (paper §4.2).

Three techniques, dispatched on the compression method's order class:

* ColSet  (ORD-IND): same column SET  => same compressed size.
* ColExt  (ORD-IND): size reductions are per-column additive:
      R(I_AB) = R(I_A) + R(I_B);   Size(I_AB^C) = Size(I_AB) - sum R(parts)
* ColExt  (ORD-DEP): additive with a fragmentation penalty.  With
      T(I_X)    tuples per page of index X
      L(I_X, Y) average run length of Y values in X
                = nrows / ndv(prefix of X's key up to and including Y)
      DV(I_X,Y) = ceil(T / L)                      if L > 1
                  |Y| - |Y|*(1 - 1/|Y|)^T          otherwise (dice throw)
      F(I_X, Y) = (T - DV) / T   (fraction of Y replaced by the dictionary)
  the reduction contributed by column Y known from part P is rescaled:
      R_Y(target) = R_Y(P) * F(target, Y) / F(P, Y)

Deductions cost nothing (no sampling, no index build): they only read
optimizer statistics (ndv / row counts).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from .compression import METHODS, uncompressed_payload_bytes
from .relation import Table, rows_per_page


def index_nrows(table: Table, predicate=None) -> int:
    if predicate is None:
        return table.nrows
    return int(predicate.mask(table).sum())


def uncompressed_size(table: Table, cols: Sequence[str]) -> float:
    key = ("ded_usize", tuple(cols))
    got = table._stats_cache.get(key)
    if got is None:
        widths = [table.col_by_name[c].width for c in cols]
        got = float(uncompressed_payload_bytes(table.nrows, widths))
        table._stats_cache[key] = got
    return got


def tuples_per_page(table: Table, cols: Sequence[str]) -> int:
    rw = sum(table.col_by_name[c].width for c in cols)
    return rows_per_page(rw)


def colset_deduce(known_size: float) -> float:
    """ColSet: identical column set under ORD-IND => identical size."""
    return known_size


def colext_ordind_deduce(table: Table, target_cols: Tuple[str, ...],
                         parts: Sequence[Tuple[Tuple[str, ...], float]]) -> float:
    """parts: [(part_cols, compressed_size_of_part)].  Parts partition target.

    R(part) = Size(part) - Size^C(part); reductions are additive (ORD-IND).
    """
    s_target = uncompressed_size(table, target_cols)
    r_total = 0.0
    for part_cols, csize in parts:
        r_total += uncompressed_size(table, part_cols) - csize
    return max(s_target - r_total, 0.0)


def _avg_run_length(table: Table, key_prefix: Tuple[str, ...]) -> float:
    """L = nrows / ndv(prefix incl. the column) — §4.2 ("we do not simply
    divide by |B| because A and B might be correlated")."""
    ndv = table.ndv(list(key_prefix))
    return table.nrows / max(ndv, 1)


def _dv_per_page(table: Table, index_cols: Tuple[str, ...], col: str) -> float:
    """DV(I_X, Y): average distinct values of Y per page of index X."""
    t = tuples_per_page(table, index_cols)
    pos = index_cols.index(col)
    prefix = index_cols[: pos + 1]
    L = _avg_run_length(table, prefix)
    if L > 1.0:
        return min(float(t), math.ceil(t / L))
    y = table.ndv([col])
    return y - y * (1.0 - 1.0 / max(y, 1)) ** t


def replaced_fraction(table: Table, index_cols: Tuple[str, ...],
                      col: str) -> float:
    """F(I_X, Y) = (T - DV) / T.  Pure in optimizer stats, so cached."""
    key = ("ded_rf", index_cols, col)
    got = table._stats_cache.get(key)
    if got is None:
        t = tuples_per_page(table, index_cols)
        dv = _dv_per_page(table, index_cols, col)
        got = table._stats_cache[key] = max((t - dv) / t, 0.0)
    return got


def replaced_fraction_batch(table: Table, index_cols: Tuple[str, ...],
                            cols: Sequence[str]) -> np.ndarray:
    """F(I_X, Y) for every Y in `cols` of index X, in one array pass.

    Gathers the per-prefix run lengths (cached table stats) once and
    evaluates the §4.2 DV formula over column vectors; element-for-element
    identical to `replaced_fraction` (same cache, same float ops), it just
    removes the per-column Python dispatch from the ColExt deduction path.
    """
    missing = [c for c in cols
               if ("ded_rf", index_cols, c) not in table._stats_cache]
    if missing:
        t = tuples_per_page(table, index_cols)
        tf = float(t)
        pos = {c: index_cols.index(c) for c in missing}
        L = np.array([_avg_run_length(table, index_cols[:pos[c] + 1])
                      for c in missing])
        long_runs = L > 1.0
        dv = np.minimum(tf, np.ceil(t / np.where(long_runs, L, 1.0)))
        if not long_runs.all():
            # dice-throw branch stays scalar: numpy's pow detects integral
            # exponents and switches to repeated squaring, which is not
            # bit-identical to CPython's libm pow in `_dv_per_page`
            for i in np.nonzero(~long_runs)[0].tolist():
                y = table.ndv([missing[i]])
                dv[i] = y - y * (1.0 - 1.0 / max(y, 1)) ** t
        frac = np.maximum((t - dv) / t, 0.0)
        for c, v in zip(missing, frac.tolist()):
            table._stats_cache[("ded_rf", index_cols, c)] = v
    return np.array([table._stats_cache[("ded_rf", index_cols, c)]
                     for c in cols])


def colext_orddep_deduce(table: Table, target_cols: Tuple[str, ...],
                         parts: Sequence[Tuple[Tuple[str, ...], float]]) -> float:
    """ORD-DEP ColExt with the fragmentation rescaling of §4.2.

    The reduction of each part is apportioned to its columns by width, then
    rescaled by F(target, Y) / F(part, Y).
    """
    s_target = uncompressed_size(table, target_cols)
    r_total = 0.0
    for part_cols, csize in parts:
        r_part = uncompressed_size(table, part_cols) - csize
        if r_part <= 0:
            continue
        widths = {c: table.col_by_name[c].width for c in part_cols}
        wsum = sum(widths.values())
        # both F vectors in one batched stats pass per part
        f_parts = replaced_fraction_batch(
            table, tuple(part_cols), part_cols).tolist()
        f_targets = replaced_fraction_batch(
            table, tuple(target_cols), part_cols).tolist()
        for i, col in enumerate(part_cols):
            r_col = r_part * widths[col] / max(wsum, 1)
            f_part = f_parts[i]
            f_target = f_targets[i]
            if f_part <= 1e-9:
                # part saw no dictionary benefit for this column; assume the
                # target cannot recover one either
                continue
            ratio = min(f_target / f_part, 1.5)  # guard noisy tiny fractions
            r_total += r_col * ratio
    return max(s_target - r_total, 0.0)


def deduce(table: Table, method: str, target_cols: Tuple[str, ...],
           parts: Sequence[Tuple[Tuple[str, ...], float]]) -> float:
    """Dispatch ColExt on the method's order class."""
    if METHODS[method].order_dependent:
        return colext_orddep_deduce(table, target_cols, parts)
    return colext_ordind_deduce(table, target_cols, parts)
