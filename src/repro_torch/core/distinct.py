"""Distinct-value estimation from sample frequency statistics (App. B.3).

Implements the Adaptive Estimator (AE) of Charikar et al. [6] plus the two
baselines the paper compares against in Table 1:

  * Optimizer  — per-column NDV stats with an independence assumption.
  * Multiply   — scale sample distinct count by 1/f.
  * AE         — frequency-statistics-based estimator (paper reports 6% err).

AE also prices GDICT at full-table cardinality from a sample.  Host NumPy,
as in the JAX package, so the estimates are bit-identical to its.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def frequency_stats(sample_keys: np.ndarray) -> Dict[int, int]:
    """f_k = number of distinct values appearing exactly k times in the sample.

    sample_keys: 1-D array of group identifiers (pre-hashed combos are fine).
    """
    _, counts = np.unique(sample_keys, return_counts=True)
    ks, fk = np.unique(counts, return_counts=True)
    return {int(k): int(v) for k, v in zip(ks, fk)}


def estimate_multiply(d_sample: int, f: float) -> float:
    """Baseline: scale the sample distinct count by the sampling ratio."""
    return d_sample / max(f, 1e-12)


def estimate_optimizer(per_col_ndv: Sequence[int], n_rows: int) -> float:
    """Baseline: single-column stats + independence assumption, capped by n."""
    prod = 1.0
    for d in per_col_ndv:
        prod *= float(d)
    return min(prod, float(n_rows))


def adaptive_estimator(freq: Dict[int, int], d: int, r: int, n: int) -> float:
    """Adaptive Estimator [6] (the "AE" of Table 1).

    freq: f_k frequency statistics from the sample
    d:    distinct values in the sample
    r:    sample size (rows)
    n:    table size (rows)

    Model (Charikar et al. [6]): values seen once or twice are "rare" and
    share a common true frequency c, estimated from the f1/f2 ratio under
    Bernoulli(p) sampling:

        E[f1]/E[f2] = 2(1-p) / ((c-1) p)   =>   c = 1 + 2(1-p) f2 / (p f1)

    A rare value goes entirely unseen with probability (1-p)^c, so the
    observed rare distinct count f1+f2 is inflated by 1/(1-(1-p)^c); values
    seen >= 3 times are assumed fully represented.
    """
    if r <= 0 or d <= 0:
        return 0.0
    if r >= n:
        return float(d)
    p = r / n
    f1 = freq.get(1, 0)
    f2 = freq.get(2, 0)
    if f1 == 0:
        return float(d)
    d_rare = f1 + f2
    d_high = d - d_rare
    if f2 == 0:
        # all singletons: no duplication evidence => scale like Multiply
        return float(min(d_high + f1 / p, n))
    c = 1.0 + 2.0 * (1.0 - p) * f2 / (p * f1)
    p_seen = 1.0 - (1.0 - p) ** c
    est = d_high + d_rare / max(p_seen, p)
    return float(min(est, float(n)))


def ae_ndv(col: np.ndarray, n_full: int) -> float:
    """Full-table NDV of one column from a sample, via the Adaptive
    Estimator.  Shared by the scalar and batched GDICT SampleCF paths, so
    both produce bit-identical estimates."""
    r = int(col.shape[0])
    freq = frequency_stats(col)
    return adaptive_estimator(freq, sum(freq.values()), r, n_full)


def gdict_estimated_col_bytes(col: np.ndarray, width: int,
                              n_full: int) -> float:
    """Estimated FULL-index GDICT payload bytes of one column.

    GDICT is the known exception to linear CF scaling: a small sample's
    dictionary is nearly all-distinct, so scaling the sample's compressed
    fraction overestimates the full dictionary (NDV does not scale with
    the sample).  Instead, estimate the full-table NDV with the App. B
    Adaptive Estimator and price the dictionary + pointers at full
    cardinality directly.
    """
    ndv = ae_ndv(col, n_full)
    ptr = 1 if ndv <= 256 else (2 if ndv <= 65536 else 3)
    return ndv * width + n_full * ptr




def estimate_group_count(sample_keys: np.ndarray, n_rows: int,
                         method: str = "AE") -> float:
    """Estimate #groups of a GROUP-BY over the full table from a sample."""
    r = int(sample_keys.shape[0])
    d = int(np.unique(sample_keys).size)
    if method == "multiply":
        return estimate_multiply(d, r / max(n_rows, 1))
    if method == "AE":
        return adaptive_estimator(frequency_stats(sample_keys), d, r, n_rows)
    raise ValueError(method)
