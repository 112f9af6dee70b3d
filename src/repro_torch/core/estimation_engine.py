"""Batched SampleCF: size estimation for many targets as array code.

The scalar path (`repro_torch.core.samplecf.sample_cf`) builds and
compresses one index per call; this engine computes every SAMPLED target
of an estimation plan in a handful of grouped kernel calls while staying
byte-identical to the scalar reference.

Batch dimensions, in the paper's terms:

* **Group axis — (table, f):** the §4.1 amortization.  One uniform sample
  of fraction `f` per table is drawn (via `SampleManager`, so the sampling
  cost of §5.1 is paid once) and shared by every target on that table.
* **Target axis — (cols, method):** each target is one compressed index
  `I^c` whose SampleCF `CF = S^c / S` (§2.2) we estimate on the group's
  sample.
* **Job axis — (prefix, column):** the unit of batched work.  A target
  with key columns (c_0..c_k) needs, for each position j, the payload
  bytes of column c_j laid out in the target's sort order.  That sequence
  depends only on the key *prefix* (c_0..c_j), so targets sharing a prefix
  share both the sort permutation and, for ORD-IND methods (which ignore
  order entirely), the per-column byte counts.

Per (table, f) group the engine collects the distinct (method, prefix,
rows-per-page) jobs, sorts one permutation per *maximal* prefix, stacks
the permuted columns into (ntargets, nrows) matrices grouped by (method,
rows-per-page), sizes them with the codec-bytes kernels, and assembles
per-target `SizeEstimate`s with the same float ops as `sample_cf`.

Backends: on numpy every step is the JAX package's NumPy code.  On torch,
each (table, f) sample is uploaded to the device once and stays there;
the permutations (`prefix_permutations_torch`) and the column stacks are
computed on the device, and NS / LDICT / PREFIX / RLE stacks run through
the kernels of `repro_torch.kernels.codec_bytes` (GDICT is priced on the
host, as on numpy).  Permutations and byte counts are bit-identical on
both.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import compression, distinct, errors
from .relation import IndexDef, Table, rows_per_page, uncompressed_pages
from .samplecf import SampleManager, SizeEstimate

# (cols, method) — method None means "uncompressed" (CF = 1.0)
TargetSpec = Tuple[Tuple[str, ...], Optional[str]]


def _maximal_prefixes(prefixes: Sequence[Tuple[str, ...]]):
    uniq = set(prefixes)
    parents = {p[:-1] for p in uniq if len(p) > 1}
    return uniq, [p for p in uniq if p not in parents]


def _fill_ancestors(out: Dict, uniq, maximal) -> Dict:
    # every needed non-maximal prefix is an ancestor of some maximal one
    for p in maximal:
        perm = out[p]
        for j in range(len(p) - 1, 0, -1):
            anc = p[:j]
            if anc in uniq and anc not in out:
                out[anc] = perm
    return out


def _prefix_permutations(sample: Table,
                         prefixes: Sequence[Tuple[str, ...]]
                         ) -> Dict[Tuple[str, ...], np.ndarray]:
    """One sort order per *maximal* prefix; shorter prefixes reuse it.

    Valid because a lexicographic sort by (c_0..c_k) orders the (c_0..c_j)
    tuples, j <= k, exactly as a sort by (c_0..c_j) does — trailing key
    columns only permute rows *within* groups of equal (c_0..c_j) values.

    Each column is replaced by its dense rank (order-isomorphic, so the
    permutation is unchanged), ranks are bit-packed into a single int64
    key per prefix, and a stable row-wise argsort sorts the whole
    (nprefixes, nrows) key matrix at once.  A prefix whose packed ranks
    exceed 63 bits falls back to np.lexsort — both are stable sorts of the
    same key sequence, hence the identical permutation.
    """
    uniq, maximal = _maximal_prefixes(prefixes)
    ranks: Dict[str, np.ndarray] = {}
    bits: Dict[str, int] = {}

    def rank_of(c: str) -> np.ndarray:
        r = ranks.get(c)
        if r is None:
            u, inv = np.unique(sample.values[c], return_inverse=True)
            r = ranks[c] = inv.astype(np.int64, copy=False)
            bits[c] = max(int(u.size - 1).bit_length(), 1)
        return r

    out: Dict[Tuple[str, ...], np.ndarray] = {}
    packable: List[Tuple[str, ...]] = []
    for p in maximal:
        for c in p:
            rank_of(c)
        if sum(bits[c] for c in p) <= 63:
            packable.append(p)
        else:
            out[p] = np.lexsort([sample.values[c] for c in reversed(p)])
    if packable:
        # depth-wise batched packing: keys[i] = fold over p of (k << b) | r
        cols_used = sorted(ranks)
        cidx = {c: i for i, c in enumerate(cols_used)}
        rmat = np.stack([ranks[c] for c in cols_used])
        bvec = np.array([bits[c] for c in cols_used], dtype=np.int64)
        keys = rmat[[cidx[p[0]] for p in packable]].copy()
        maxlen = max(len(p) for p in packable)
        for d in range(1, maxlen):
            sel = np.array([i for i, p in enumerate(packable) if len(p) > d])
            if not sel.size:
                continue
            ci = np.array([cidx[packable[i][d]] for i in sel])
            keys[sel] = (keys[sel] << bvec[ci, None]) | rmat[ci]
        perms = np.argsort(keys, axis=1, kind="stable")
        for i, p in enumerate(packable):
            out[p] = perms[i]
    return _fill_ancestors(out, uniq, maximal)


def prefix_permutations_torch(cols: Dict[str, torch.Tensor],
                              prefixes: Sequence[Tuple[str, ...]]
                              ) -> Dict[Tuple[str, ...], torch.Tensor]:
    """`_prefix_permutations` on the device, bit-identical: dense ranks
    from `torch.unique(return_inverse=True)`, the same rank packing, and a
    stable `torch.sort` of the packed keys; a prefix whose ranks exceed 63
    bits sorts by successive stable sorts from its last column to its
    first (what np.lexsort computes)."""
    uniq, maximal = _maximal_prefixes(prefixes)
    ranks: Dict[str, torch.Tensor] = {}
    bits: Dict[str, int] = {}

    def rank_of(c: str) -> torch.Tensor:
        r = ranks.get(c)
        if r is None:
            u, inv = torch.unique(cols[c], sorted=True, return_inverse=True)
            r = ranks[c] = inv.to(torch.int64)
            bits[c] = max(int(u.numel() - 1).bit_length(), 1)
        return r

    out: Dict[Tuple[str, ...], torch.Tensor] = {}
    packable: List[Tuple[str, ...]] = []
    for p in maximal:
        for c in p:
            rank_of(c)
        if sum(bits[c] for c in p) <= 63:
            packable.append(p)
            continue
        first = cols[p[0]]
        perm = torch.arange(first.numel(), device=first.device)
        for c in reversed(p):
            perm = perm[torch.sort(cols[c][perm], stable=True).indices]
        out[p] = perm
    if packable:
        keys = []
        for p in packable:
            k = ranks[p[0]]
            for c in p[1:]:
                k = (k << bits[c]) | ranks[c]
            keys.append(k)
        perms = torch.sort(torch.stack(keys), dim=1, stable=True).indices
        for i, p in enumerate(packable):
            out[p] = perms[i]
    return _fill_ancestors(out, uniq, maximal)


def batched_sample_cf(table: Table, sample: Table,
                      specs: Sequence[TargetSpec], f: float,
                      device_cols: Optional[Dict[str, torch.Tensor]] = None
                      ) -> List[SizeEstimate]:
    """SampleCF for every (cols, method) spec on one shared sample.

    `table` provides column widths and the full-index row count used to
    scale CF back up (§2.2); `sample` is the (table, f) sample the indexes
    are built on.  With `device_cols` (the sample's columns as torch
    tensors) the permutations, column stacks and codec kernels run on
    their device (the torch backend); without, in NumPy.  Returns
    estimates aligned with `specs`, byte-identical to calling `sample_cf`
    per target.
    """
    n = sample.nrows
    widths_of = {c.name: table.col_by_name[c.name].width
                 for c in sample.columns}
    on_device = device_cols is not None
    backend = "torch" if on_device else "numpy"

    def rpp_key(rpp: int) -> int:
        # Any rows-per-page >= n yields a single page holding all n rows,
        # and single-page sizes are rpp-independent (padding repeats the
        # last value, which adds no distinct values, runs, or min/max
        # movement) — so such jobs collapse into one per (method, prefix).
        return rpp if 0 < rpp < n else max(n, 1)

    def sized(method: str, colvecs: list, jcols: list, rpp: int) -> list:
        w = [widths_of[c] for c in jcols]
        if on_device:
            mat = torch.stack(colvecs)
            w = torch.tensor(w, dtype=torch.int64, device=mat.device)
        else:
            mat = np.stack(colvecs)
            w = np.array(w, dtype=np.int64)
        return compression.batched_bytes(method, mat, w, rpp,
                                         backend=backend).tolist()

    # ---- collect the distinct sizing jobs across all targets ----
    ordind_jobs = set()           # (method, col)
    orddep_jobs = set()           # (method, prefix, rpp_key)
    gdict_jobs = set()            # col — AE-priced at full cardinality
    for cols, method in specs:
        if method is None:
            continue
        rpp = rpp_key(rows_per_page(sum(widths_of[c] for c in cols)))
        order_dep = compression.METHODS[method].order_dependent
        for j, c in enumerate(cols):
            if method == "GDICT":
                gdict_jobs.add(c)
            elif order_dep:
                orddep_jobs.add((method, cols[:j + 1], rpp))
            else:
                ordind_jobs.add((method, c))

    # ---- closed forms for single-page order-dependent jobs ----
    # When the whole sample fits in one page, LDICT's page dictionary sees
    # the column's full multiset (ndv) and PREFIX sees its global min/max —
    # both independent of the sort order — so these jobs reduce to O(1)
    # arithmetic on per-column stats the sample Table already caches.
    col_bytes: Dict[Tuple, int] = {}
    kernel_jobs = set()
    single = max(n, 1)
    for job in orddep_jobs:
        method, prefix, rpp = job
        c = prefix[-1]
        w = widths_of[c]
        cap = n * w + compression.PAGE_META
        if rpp == single and method == "LDICT":
            ndv = sample.ndv([c])
            ptr = int(compression._ptr_bytes(ndv))
            col_bytes[job] = min(ndv * w + n * ptr + compression.PAGE_META,
                                 cap)
        elif rpp == single and method == "PREFIX":
            mn, mx = sample.minmax(c)
            # uint64 semantics, like the kernel's significant_bytes cast
            xor = (mn ^ mx) & 0xFFFFFFFFFFFFFFFF
            diff_bytes = (xor.bit_length() + 7) // 8  # significant_bytes
            common = max(w - diff_bytes, 0)
            col_bytes[job] = min(
                common + n * (1 + w - common) + compression.PAGE_META, cap)
        else:
            kernel_jobs.add(job)

    # ---- GDICT: App. B Adaptive-Estimator pricing (samplecf parity) ----
    # NDV does not scale with the sample, so GDICT sizes are not CF-scaled:
    # full-table NDV is estimated per column on the host and the full
    # index priced directly, bit-identical to the scalar sample_cf path.
    gdict_bytes: Dict[str, float] = {
        c: distinct.gdict_estimated_col_bytes(sample.values[c],
                                              widths_of[c], table.nrows)
        for c in gdict_jobs}

    prefixes = [p for (_, p, _) in kernel_jobs]
    if not kernel_jobs:
        perms = {}
    elif on_device:
        perms = prefix_permutations_torch(device_cols, prefixes)
    else:
        perms = _prefix_permutations(sample, prefixes)
    values = device_cols if on_device else sample.values

    # ---- grouped kernel calls ----
    by_method: Dict[str, List[str]] = {}
    for method, c in ordind_jobs:
        by_method.setdefault(method, []).append(c)
    for method, jcols in by_method.items():
        # ORD-IND sizes ignore row order: use raw sample order
        got = sized(method, [values[c] for c in jcols], jcols,
                    rows_per_page(1))
        for c, b in zip(jcols, got):
            col_bytes[(method, c)] = int(b)

    by_group: Dict[Tuple[str, int], List[Tuple[str, ...]]] = {}
    for method, prefix, rpp in kernel_jobs:
        by_group.setdefault((method, rpp), []).append(prefix)
    for (method, rpp), group in by_group.items():
        got = sized(method, [values[p[-1]][perms[p]] for p in group],
                    [p[-1] for p in group], rpp)
        for p, b in zip(group, got):
            col_bytes[(method, p, rpp)] = int(b)

    # ---- per-target assembly (same float ops, same order, as sample_cf) --
    colset_cache: Dict[Tuple[str, ...], Tuple] = {}

    def colset_consts(cols: Tuple[str, ...]) -> Tuple:
        got = colset_cache.get(cols)
        if got is None:
            widths = [widths_of[c] for c in cols]
            got = colset_cache[cols] = (
                rpp_key(rows_per_page(sum(widths))),
                compression.uncompressed_payload_bytes(n, widths),
                compression.uncompressed_payload_bytes(table.nrows, widths),
                float(uncompressed_pages(n, widths)))
        return got

    out: List[SizeEstimate] = []
    for cols, method in specs:
        rpp, s, full_bytes, cost = colset_consts(tuple(cols))
        if method is None or n == 0 or s == 0:
            cf = 1.0
        elif method == "GDICT":
            # full-cardinality AE pricing (same op order as sample_cf)
            sc = table.nrows * compression.ROW_OVERHEAD
            for c in cols:
                sc = sc + gdict_bytes[c]
            cf = min(sc / full_bytes / errors.samplecf_bias(method, f), 1.0)
        else:
            order_dep = compression.METHODS[method].order_dependent
            sc = n * compression.ROW_OVERHEAD
            for j, c in enumerate(cols):
                sc += col_bytes[(method, cols[:j + 1], rpp)] if order_dep \
                    else col_bytes[(method, c)]
            cf = min(sc / s / errors.samplecf_bias(method, f), 1.0)
        out.append(SizeEstimate(
            index=IndexDef(table.name, tuple(cols), method),
            est_bytes=cf * full_bytes, method="samplecf",
            cost_pages=cost, cf=cf))
    return out


class EstimationEngine:
    """Batched SampleCF over a schema and an amortized sample store.

    Accepts any target objects carrying `.table`, `.cols` and `.method`
    (`estimation_graph.NodeKey` in the advisor pipeline) and estimates all
    of them per (table, f) group in grouped kernel calls.  With a `device`
    (the torch backend) each (table, f) sample is uploaded once, in one
    transfer, and kept on the device for the engine's lifetime.
    """

    def __init__(self, tables: Dict[str, Table], manager: SampleManager,
                 device: Optional[torch.device] = None):
        self.tables = dict(tables)
        self.manager = manager
        self.device = device
        self._device_samples: Dict[Tuple[str, float],
                                   Dict[str, torch.Tensor]] = {}
        self.batch_calls = 0        # per-(table, f) group batches run
        self.targets_estimated = 0  # total targets sized through the engine

    def stats(self) -> Dict[str, int]:
        return {"batch_calls": self.batch_calls,
                "targets_estimated": self.targets_estimated,
                "device_samples": len(self._device_samples)}

    def device_sample(self, table_name: str, f: float
                      ) -> Dict[str, torch.Tensor]:
        """The (table, f) sample's columns on the device (uploaded once)."""
        key = (table_name, round(f, 6))
        got = self._device_samples.get(key)
        if got is None:
            sample = self.manager.get_sample(table_name, f)
            names = [c.name for c in sample.columns]
            mat = torch.from_numpy(
                np.stack([sample.values[c] for c in names])).to(self.device)
            got = self._device_samples[key] = dict(zip(names, mat.unbind(0)))
        return got

    def estimate_batch(self, targets: Sequence, f: float) -> Dict:
        """SizeEstimate for every target, keyed by the target objects."""
        by_table: Dict[str, List] = {}
        for t in targets:
            by_table.setdefault(t.table, []).append(t)
        out: Dict = {}
        for tname, ts in by_table.items():
            sample = self.manager.get_sample(tname, f)
            dev = (self.device_sample(tname, f) if self.device is not None
                   else None)
            ests = batched_sample_cf(
                self.tables[tname], sample, [(t.cols, t.method) for t in ts],
                f, device_cols=dev)
            out.update(zip(ts, ests))
            self.batch_calls += 1
            self.targets_estimated += len(ts)
        return out
