"""Filtered samples, join synopses and MV samples (paper Appendix B).

* Filtered sample: apply a partial index's WHERE to the base sample (B.1).
* Join synopsis [2]: sample the fact table once, join the sample against the
  ORIGINAL dimension tables so every FK finds its match (B.2).
* MV sample with aggregation: GROUP BY on the synopsis, keep COUNT(*) as
  frequency statistics, and estimate the MV cardinality with the Adaptive
  Estimator (B.3) — the paper's Table 1.

Samples, joins and group counts are host NumPy, as in the JAX package, so
they are bit-identical to its; `SynopsisManager(device=...)` runs the MV
index's SampleCF codecs on that device (`batched_sample_cf` with
`device_cols`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import compression, distinct
from .estimation_engine import batched_sample_cf
from .relation import ColumnDef, Predicate, Table
from .samplecf import SampleManager, SizeEstimate


@dataclasses.dataclass(frozen=True)
class ForeignKey:
    fact_table: str
    fk_col: str
    dim_table: str
    dim_key: str


@dataclasses.dataclass(frozen=True)
class MVDef:
    """SELECT <cols>[, aggs] FROM fact JOIN dims WHERE pred GROUP BY group_by."""
    name: str
    fact_table: str
    joins: Tuple[ForeignKey, ...] = ()
    cols: Tuple[str, ...] = ()            # projected (pre-aggregation) columns
    predicate: Optional[Predicate] = None
    group_by: Tuple[str, ...] = ()        # empty => no aggregation


class Schema:
    def __init__(self, tables: Dict[str, Table],
                 foreign_keys: Sequence[ForeignKey] = ()):
        self.tables = dict(tables)
        self.foreign_keys = tuple(foreign_keys)

    def fks_of(self, fact: str) -> Tuple[ForeignKey, ...]:
        return tuple(fk for fk in self.foreign_keys if fk.fact_table == fact)


def join_sample_with_dims(sample: Table, schema: Schema,
                          joins: Sequence[ForeignKey]) -> Table:
    """Join a fact-table sample with ORIGINAL dimension tables (join synopsis).

    Dimension keys are assumed unique; FK values always match (B.2).  The
    synopsis indexes dimension keys once for fast lookup (B.4).
    """
    cols = list(sample.columns)
    vals = {c.name: sample.values[c.name] for c in sample.columns}
    for fk in joins:
        dim = schema.tables[fk.dim_table]
        keys = dim.values[fk.dim_key]
        order = np.argsort(keys, kind="stable")       # the "index" of B.4
        pos = np.searchsorted(keys[order], vals[fk.fk_col])
        pos = np.clip(pos, 0, keys.size - 1)
        rows = order[pos]
        matched = keys[rows] == vals[fk.fk_col]
        if not bool(np.all(matched)):
            # keep only matching rows (inner join semantics)
            keep = np.nonzero(matched)[0]
            vals = {k: v[keep] for k, v in vals.items()}
            rows = rows[keep]
        for c in dim.columns:
            if c.name == fk.dim_key or c.name in vals:
                continue
            cols.append(c)
            vals[c.name] = dim.values[c.name][rows]
    return Table(f"{sample.name}#syn", cols, vals)


class SynopsisManager:
    """Maintains join synopses + filtered/MV samples on top of SampleManager.

    `device` None sizes MV indexes in NumPy; a torch device uploads each MV
    sample's columns once and runs the codec kernels there."""

    def __init__(self, schema: Schema, samples: SampleManager,
                 device: Optional[torch.device] = None):
        self.schema = schema
        self.samples = samples
        self.device = device
        self._synopses: Dict[Tuple[str, float], Table] = {}

    def join_synopsis(self, fact: str, f: float) -> Table:
        key = (fact, round(f, 6))
        if key not in self._synopses:
            base = self.samples.get_sample(fact, f)
            self._synopses[key] = join_sample_with_dims(
                base, self.schema, self.schema.fks_of(fact))
        return self._synopses[key]

    def filtered_sample(self, table: str, pred: Predicate, f: float) -> Table:
        base = self.samples.get_sample(table, f)
        rows = np.nonzero(pred.mask(base))[0]
        return base.take(rows, name=f"{table}#filt")

    # ------------------------------------------------------------------
    # MV sample + cardinality (Algorithm CreateMVSample, B.3)
    # ------------------------------------------------------------------
    def mv_sample(self, mv: MVDef, f: float) -> Tuple[Table, float]:
        """Returns (sample table of the MV, estimated MV row count)."""
        syn = self.join_synopsis(mv.fact_table, f) if mv.joins else \
            self.samples.get_sample(mv.fact_table, f)
        if mv.predicate is not None:
            rows = np.nonzero(mv.predicate.mask(syn))[0]
            syn = syn.take(rows)
        fact = self.schema.tables[mv.fact_table]
        r = syn.nrows
        if not mv.group_by:
            # no aggregation: cardinality scales with the filter factor
            n_est = fact.nrows * (r / max(self.samples.get_sample(
                mv.fact_table, f).nrows, 1))
            cols = [c for c in syn.columns if c.name in mv.cols]
            vals = {c.name: syn.values[c.name] for c in cols}
            return Table(mv.name + "#sample", cols, vals), float(n_est)

        # GROUP BY: build the grouped sample, keep COUNT(*) as `cnt`
        keys = np.stack([syn.values[c] for c in mv.group_by], axis=1)
        uniq, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                                      return_counts=True)
        out_cols = [ColumnDef(c, syn.col_by_name[c].width)
                    for c in mv.group_by]
        out_vals = {c: uniq[:, i] for i, c in enumerate(mv.group_by)}
        out_cols.append(ColumnDef("cnt", 4))
        out_vals["cnt"] = np.minimum(counts, (1 << 31) - 1)
        smv = Table(mv.name + "#sample", out_cols, out_vals)

        # Adaptive Estimator on the sample's frequency statistics
        hashed = inv  # group id per sample row
        n_est = distinct.estimate_group_count(hashed, fact.nrows, "AE")
        return smv, float(n_est)

    def mv_index_size(self, mv: MVDef, idx_cols: Tuple[str, ...],
                      method: Optional[str], f: float) -> SizeEstimate:
        """SampleCF for an index on an MV, scaled by the AE cardinality."""
        smv, n_est = self.mv_sample(mv, f)
        dev = None
        if self.device is not None:
            dev = {c: torch.from_numpy(np.ascontiguousarray(
                smv.values[c])).to(self.device) for c in idx_cols}
        # the MV sample IS the whole "table" here (f=1): batched core with
        # a single (cols, method) spec, then rescale by the AE cardinality
        est = batched_sample_cf(smv, smv, [(idx_cols, method)], f=1.0,
                                device_cols=dev)[0]
        widths = [smv.col_by_name[c].width for c in idx_cols]
        full = compression.uncompressed_payload_bytes(int(n_est), widths)
        return SizeEstimate(index=est.index, est_bytes=est.cf * full,
                            method="samplecf:mv", cost_pages=est.cost_pages,
                            cf=est.cf)
