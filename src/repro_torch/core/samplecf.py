"""SampleCF (paper §2.2) with per-table amortized sampling (§4.1).

SampleCF(I, method, f): take a uniform random sample of fraction f of I's
table (ONE sample per (table, f), reused for every index on that table —
the §4.1 amortization), build the index on the sample, compress it, and
return CF = S^c / S.

The *cost* of a SampleCF call is modeled as the number of pages of the
index built on the sample, before compression (paper §5.1).

`SampleManager` draws each (table, f) sample from the same seed-derived
NumPy stream as the JAX package's, so both packages size the same rows.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np

from . import compression, distinct, errors
from .relation import IndexDef, Table, build_index_data, uncompressed_pages


@dataclasses.dataclass
class SizeEstimate:
    index: IndexDef
    est_bytes: float
    method: str            # "samplecf" | "deduction:..." | "exact"
    cost_pages: float      # estimation cost charged (paper §5.1)
    cf: float              # estimated compression fraction


class SampleManager:
    """Caches per-(table, f) samples so sampling cost is paid once (§4.1).

    Each (table, f) sample is drawn from its own seed-derived RNG stream,
    so the sample content depends only on (seed, table, f) — never on the
    *order* samples were first requested in.
    """

    def __init__(self, tables: Dict[str, Table], seed: int = 0):
        self.tables = dict(tables)
        self.seed = int(seed)
        self._samples: Dict[Tuple[str, float], Table] = {}
        self.sampling_calls = 0  # how many fresh samples were drawn

    def _rng_for(self, table_name: str, f: float) -> np.random.Generator:
        # the f quantization MUST match the sample-cache key below: a
        # finer-grained seed would reintroduce draw-order dependence for
        # f values that collide in the cache
        key = (self.seed, zlib.crc32(table_name.encode("utf-8")),
               int(round(round(f, 6) * 1e6)))
        return np.random.default_rng(key)

    def get_sample(self, table_name: str, f: float) -> Table:
        key = (table_name, round(f, 6))
        if key not in self._samples:
            t = self.tables[table_name]
            n = max(2, int(round(t.nrows * f)))
            n = min(n, t.nrows)
            rng = self._rng_for(table_name, f)
            rows = rng.choice(t.nrows, size=n, replace=False)
            self._samples[key] = t.take(np.sort(rows))
            self.sampling_calls += 1
        return self._samples[key]


def sample_cf(manager: SampleManager, idx: IndexDef, f: float
              ) -> SizeEstimate:
    """Estimate the compressed size of `idx` via SampleCF on the amortized
    (table, f) sample.  The estimate is divided by the fitted E[X] of the
    method's error model (beyond-paper extension; see
    errors.samplecf_bias).
    """
    table = manager.tables[idx.table]
    sample = manager.get_sample(idx.table, f)
    widths = [table.col_by_name[c].width for c in idx.cols]

    data = build_index_data(sample, idx)
    n_sample = data.shape[0]
    s = compression.uncompressed_payload_bytes(n_sample, widths)
    # full index cardinality the estimate is scaled to
    if idx.predicate is not None:
        full_rows = int(idx.predicate.mask(table).sum())
    else:
        full_rows = table.nrows
    full_bytes = compression.uncompressed_payload_bytes(full_rows, widths)
    if idx.compression is None:
        cf = 1.0
    elif n_sample == 0 or s == 0:
        cf = 1.0
    elif idx.compression == "GDICT":
        # NDV does not scale with the sample (the dictionary of a small
        # sample is nearly all-distinct), so linear CF scaling
        # over-estimates GDICT; price the full index directly with the
        # App. B Adaptive Estimator instead.
        sc = full_rows * compression.ROW_OVERHEAD
        for j, w in enumerate(widths):
            sc = sc + distinct.gdict_estimated_col_bytes(
                data[:, j], w, full_rows)
        cf = sc / full_bytes
        cf = min(cf / errors.samplecf_bias(idx.compression, f), 1.0)
    else:
        sc = compression.compressed_payload_bytes(idx.compression, data, widths)
        cf = sc / s
        cf = min(cf / errors.samplecf_bias(idx.compression, f), 1.0)
    cost = uncompressed_pages(n_sample, widths)
    return SizeEstimate(index=idx, est_bytes=cf * full_bytes,
                        method="samplecf", cost_pages=float(cost), cf=cf)
