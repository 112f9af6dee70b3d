"""Tensor physical-design advisor — the paper's DTAc, re-targeted at a
training/serving job on an accelerator.

"Indexes" are the persistent tensor classes of a job (weights, optimizer
moments, gradients-on-the-wire, KV cache); "compression methods" are the
codecs; the "storage bound" is per-chip HBM; the what-if "query optimizer"
is the roofline step-cost model; SELECT- vs INSERT-intensity is the
read/write ratio of each class per step.

The search is the paper's: per-class candidates -> (bytes, cost) skyline
(§6.1) -> greedy enumeration with oversized-choice backtracking (§6.2).

Counterpart of the JAX package's `design/advisor.py`, line for line; the
hardware constants come from the port's `launch/roofline.py` (one H100),
so its choices can differ from the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from ..models.config import ModelConfig
from .codecs import CODECS, Codec


@dataclasses.dataclass(frozen=True)
class TensorClass:
    """One persistent tensor class of a job (an 'index' of the paper)."""
    name: str
    n_elements: float
    reads_per_step: float    # element-reads per step (beta charge)
    writes_per_step: float   # element-writes per step (alpha charge)
    allowed: Tuple[str, ...]  # codec candidates
    quality_floor: str = ""  # codec names below this are disallowed


@dataclasses.dataclass(frozen=True)
class Choice:
    tclass: str
    codec: str
    hbm_bytes: float
    step_cost_s: float


@dataclasses.dataclass
class LayoutPlan:
    choices: Dict[str, str]          # class -> codec
    hbm_bytes: float
    step_cost_s: float
    log: List[str]


def job_tensor_classes(cfg: ModelConfig, kind: str, batch: int, seq: int,
                       n_chips: int) -> List[TensorClass]:
    """Tensor classes for a (train|serve) job, per chip."""
    n = cfg.param_count(padded=True) / n_chips
    out = [TensorClass("weights", n,
                       reads_per_step=(3.0 if kind == "train" else 1.0) * n,
                       writes_per_step=(n if kind == "train" else 0.0),
                       allowed=("f32", "bf16", "q8") if kind != "train"
                       else ("f32", "bf16"))]
    if kind == "train":
        out.append(TensorClass("adam_m", n, reads_per_step=n,
                               writes_per_step=n, allowed=("f32", "q8")))
        out.append(TensorClass("adam_v", n, reads_per_step=n,
                               writes_per_step=n, allowed=("f32", "q8")))
        out.append(TensorClass("grad_wire", n, reads_per_step=n,
                               writes_per_step=n, allowed=("f32", "bf16",
                                                           "q8")))
    else:
        kv_heads = cfg.kv_heads if (cfg.mixer == "attn" or cfg.hybrid) else 0
        if kv_heads:
            n_attn = cfg.attn_layers
            kv = 2.0 * n_attn * batch * seq * kv_heads * cfg.d_head / n_chips
            out.append(TensorClass("kv_cache", kv, reads_per_step=kv,
                                   writes_per_step=kv / max(seq, 1),
                                   allowed=("f32", "bf16", "q8", "q4")))
    return out


def step_cost(classes: Sequence[TensorClass], choices: Dict[str, str],
              base_flops_per_chip: float) -> Tuple[float, float]:
    """(hbm_bytes, step_seconds) under the compression-aware cost model.

    Appendix A verbatim: CPU_update = base + alpha*writes;
    CPU_read = base + beta*reads; I/O shrinks with compressed size.  Here
    'CPU' is elementwise codec time (elements/s ~ PEAK/16 in relative
    units), 'I/O' is HBM traffic; grad_wire bytes ride the inter-chip
    links, not HBM.
    """
    vpu_el_per_s = PEAK_FLOPS / 16.0  # rough elementwise throughput
    t_compute = base_flops_per_chip / PEAK_FLOPS
    t_hbm = 0.0
    t_wire = 0.0
    t_vpu = 0.0
    hbm = 0.0
    for c in classes:
        codec = CODECS[choices[c.name]]
        bpe = codec.bytes_per_element
        assert bpe is not None
        size = c.n_elements * bpe
        traffic = (c.reads_per_step + c.writes_per_step) * bpe
        if c.name == "grad_wire":
            t_wire += traffic / LINK_BW   # wire bytes, not HBM residency
        else:
            hbm += size
            t_hbm += traffic / HBM_BW
        t_vpu += codec.beta * c.reads_per_step / vpu_el_per_s
        t_vpu += codec.alpha * c.writes_per_step / vpu_el_per_s
    # Roofline overlap: compute and HBM streams overlap (max), codec
    # elementwise work and wire transfers serialize on top.  When a job is
    # compute-bound, compressing a tensor saves NO step time but still pays
    # alpha/beta — the advisor then correctly declines to compress unless
    # the HBM budget forces it (the paper's Example 2, accelerator edition).
    t = max(t_compute, t_hbm) + t_wire + t_vpu
    return hbm, t


def skyline(candidates: Sequence[Choice]) -> List[Choice]:
    """(bytes, cost) Pareto frontier per class (paper §6.1)."""
    out = []
    for c in candidates:
        if not any(o.hbm_bytes <= c.hbm_bytes and o.step_cost_s <= c.step_cost_s
                   and (o.hbm_bytes < c.hbm_bytes
                        or o.step_cost_s < c.step_cost_s)
                   for o in candidates if o is not c):
            out.append(c)
    return sorted(out, key=lambda c: -c.hbm_bytes)


def plan_layout(cfg: ModelConfig, kind: str, batch: int, seq: int,
                n_chips: int, hbm_budget_bytes: float,
                base_flops_per_chip: float = 0.0) -> LayoutPlan:
    """Greedy-with-backtracking enumeration (paper §6.2) over codec choices.

    Start from the FASTEST (largest) codec per class; while over budget,
    greedily apply the compression step with the best bytes-saved per
    cost-added (density); backtrack: if a class hits its smallest codec and
    the budget still fails, recover by re-expanding the cheapest class and
    compressing a different one (Figure 8's replace-member recovery).
    """
    classes = job_tensor_classes(cfg, kind, batch, seq, n_chips)
    log: List[str] = []

    # per-class skyline of (bytes, cost) single-choice configurations
    per_class: Dict[str, List[Choice]] = {}
    for c in classes:
        cands = []
        for codec in c.allowed:
            trial = {cc.name: (codec if cc.name == c.name else cc.allowed[0])
                     for cc in classes}
            b, t = step_cost(classes, trial, base_flops_per_chip)
            cands.append(Choice(c.name, codec, b, t))
        per_class[c.name] = skyline(cands)
        log.append(f"skyline[{c.name}]: "
                   + ", ".join(f"{x.codec}({x.hbm_bytes/1e9:.2f}GB,"
                               f"{x.step_cost_s*1e3:.2f}ms)"
                               for x in per_class[c.name]))

    # greedy: start fastest, compress by best density until within budget
    choices = {c.name: min(per_class[c.name],
                           key=lambda x: x.step_cost_s).codec
               for c in classes}
    for _ in range(32):
        hbm, t = step_cost(classes, choices, base_flops_per_chip)
        if hbm <= hbm_budget_bytes:
            break
        best = None
        for c in classes:
            cur = CODECS[choices[c.name]]
            for ch in per_class[c.name]:
                codec = CODECS[ch.codec]
                if codec.bytes_per_element >= cur.bytes_per_element:
                    continue
                trial = dict(choices)
                trial[c.name] = ch.codec
                b2, t2 = step_cost(classes, trial, base_flops_per_chip)
                saved = hbm - b2
                dcost = max(t2 - t, 1e-12)
                score = saved / dcost
                if best is None or score > best[0]:
                    best = (score, c.name, ch.codec)
        if best is None:
            log.append("backtrack: no further compression available; "
                       "budget infeasible")
            break
        choices[best[1]] = best[2]
        log.append(f"compress {best[1]} -> {best[2]}")

    hbm, t = step_cost(classes, choices, base_flops_per_chip)
    # Figure-8 style recovery: try relaxing one class back up if a cheaper
    # combination fits (greedy overshoot repair)
    improved = True
    while improved:
        improved = False
        for c in classes:
            for ch in per_class[c.name]:
                if ch.codec == choices[c.name]:
                    continue
                trial = dict(choices)
                trial[c.name] = ch.codec
                b2, t2 = step_cost(classes, trial, base_flops_per_chip)
                if b2 <= hbm_budget_bytes and t2 < t:
                    choices, hbm, t = trial, b2, t2
                    log.append(f"backtrack-recover: {c.name} -> {ch.codec}")
                    improved = True
    return LayoutPlan(choices=choices, hbm_bytes=hbm, step_cost_s=t, log=log)
