"""SampleCF (paper §2.2) with per-table amortized sampling (§4.1).

SampleCF(I, method, f): take a uniform random sample of fraction f of I's
table (ONE sample per (table, f), reused for every index on that table —
the §4.1 amortization), build the index on the sample, compress it, and
return CF = S^c / S.

The *cost* of a SampleCF call is modeled as the number of pages of the
index built on the sample, before compression (paper §5.1).

`SampleManager` draws each (table, f) sample from the same seed-derived
NumPy stream as the JAX package's, so both packages size the same rows.
`schema_fingerprint` digests what every estimate depends on (the same
digest as the JAX package's), and `EstimateCache` is the online session's
bounded (NodeKey, f) -> `SizeEstimate` cache.
"""
from __future__ import annotations

import dataclasses
import hashlib
import zlib
from collections import OrderedDict
from typing import Dict, Iterator, MutableMapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from . import compression, distinct, errors
from .relation import IndexDef, Table, build_index_data, rows_per_page, \
    uncompressed_pages


def table_fingerprint(table: Table) -> str:
    """Content digest of a table: name, row count, column defs and the raw
    int64 column buffers.  Tables are immutable once built, so the digest
    is cached in the table's stats cache."""
    key = ("content_fingerprint",)
    fp = table._stats_cache.get(key)
    if fp is None:
        h = hashlib.sha256()
        h.update(table.name.encode("utf-8"))
        h.update(str(table.nrows).encode("ascii"))
        for c in table.columns:
            h.update(f"|{c.name}:{c.width}".encode("utf-8"))
            h.update(np.ascontiguousarray(table.values[c.name]).tobytes())
        fp = table._stats_cache[key] = h.hexdigest()
    return fp


def schema_fingerprint(schema, sample_seed: int) -> str:
    """Digest of everything SampleCF estimates depend on: every table's
    content, the foreign keys and the sampling seed.  Two workloads with
    equal fingerprints draw byte-identical samples for any (table, f), and
    so give byte-identical `SizeEstimate`s for any (NodeKey, f): the
    condition for sharing one `SampleManager` and one estimate cache."""
    h = hashlib.sha256()
    h.update(str(int(sample_seed)).encode("ascii"))
    for name in sorted(schema.tables):
        h.update(table_fingerprint(schema.tables[name]).encode("ascii"))
    for fk in schema.foreign_keys:
        h.update(f"|{fk.fact_table}.{fk.fk_col}->"
                 f"{fk.dim_table}.{fk.dim_key}".encode("utf-8"))
    return h.hexdigest()


@dataclasses.dataclass
class SizeEstimate:
    index: IndexDef
    est_bytes: float
    method: str            # "samplecf" | "deduction:..." | "exact"
    cost_pages: float      # estimation cost charged (paper §5.1)
    cf: float              # estimated compression fraction


class EstimateCache(MutableMapping):
    """Bounded LRU (NodeKey, f) -> `SizeEstimate` mapping.

    A drop-in for the plain dict an `AdvisorSession` caches its SampleCF
    estimates in, capped at `maxsize` entries with least-recently-USED
    eviction (`get` and `__getitem__` refresh recency; `__contains__` and
    `items` are pure peeks).  Eviction cannot change a result: every entry
    is a pure function of (schema content, sample seed, NodeKey, f), so an
    evicted entry is recomputed bit-identically on the next miss.
    """

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError("EstimateCache maxsize must be >= 1")
        self.maxsize = int(maxsize)
        self._d: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __getitem__(self, key):
        v = self._d[key]           # KeyError propagates on a miss
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def get(self, key, default=None):
        try:
            v = self._d[key]
        except KeyError:
            self.misses += 1
            return default
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def __setitem__(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self.evictions += 1

    def __delitem__(self, key) -> None:
        del self._d[key]

    def __contains__(self, key) -> bool:
        # pure membership: no recency touch, no counter
        return key in self._d

    def __iter__(self) -> Iterator:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def items(self):
        # a pure peek too: snapshotting the cache must neither count hits
        # nor reorder it mid-iteration
        return list(self._d.items())

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._d), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


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

    def add_table(self, table: Table) -> None:
        self.tables[table.name] = table

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


def full_index_sizes(table: Table, idx: IndexDef,
                     device: Optional[torch.device] = None
                     ) -> Tuple[int, int]:
    """(uncompressed_bytes, compressed_bytes) by building the FULL index.

    Prohibitively expensive in a real tool (this is the paper's point) —
    used here only as ground truth for accuracy experiments.  Without
    `device` the codec runs in NumPy; with one, on that device
    (`compressed_index_bytes`), the same integer bytes.
    """
    data = build_index_data(table, idx)
    widths = [table.col_by_name[c].width for c in idx.cols]
    s = compression.uncompressed_payload_bytes(data.shape[0], widths)
    if idx.compression is None:
        return s, s
    return s, compressed_index_bytes(data, widths, idx.compression, device)


def exact_size(table: Table, idx: IndexDef,
               device: Optional[torch.device] = None) -> SizeEstimate:
    """Size of an index that already exists: zero cost, zero error
    (§5.1), from the whole index built and sized on `device`
    (`full_index_sizes`)."""
    s, sc = full_index_sizes(table, idx, device)
    return SizeEstimate(index=idx, est_bytes=float(sc), method="exact",
                        cost_pages=0.0, cf=sc / max(s, 1))


def compressed_index_bytes(data: np.ndarray, widths: Sequence[int],
                           method: str,
                           device: Optional[torch.device] = None) -> int:
    """Compressed payload bytes of a built index (`build_index_data`'s
    (nrows, ncols) matrix in index order) under `method`.  Without
    `device`, NumPy (`compression.compressed_payload_bytes`); with one,
    the index goes to the device in one transfer and each of its columns
    is sized as a one-row stack by the codec's kernel
    (`compression.batched_bytes`)."""
    if device is None:
        return compression.compressed_payload_bytes(method, data, widths)
    rpp = rows_per_page(int(sum(widths)))
    cols = torch.from_numpy(np.ascontiguousarray(data.T)).to(device)
    sc = data.shape[0] * compression.ROW_OVERHEAD
    for j, w in enumerate(widths):
        wt = torch.tensor([w], dtype=torch.int64, device=cols.device)
        sc += int(compression.batched_bytes(method, cols[j:j + 1], wt, rpp,
                                            backend="torch")[0])
    return int(sc)


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
