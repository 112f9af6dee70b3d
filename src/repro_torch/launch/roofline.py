"""Roofline terms of one H100 per step, from counted work (no hardware).

    compute term    = FLOPs per chip / PEAK_FLOPS
    memory term     = HBM bytes per chip / HBM_BW
    collective term = collective wire bytes per chip / LINK_BW

Counterpart of the JAX package's `launch/roofline.py`.  There the FLOPs
and bytes come from XLA's `cost_analysis()` of a compiled program and the
collectives from its HLO text; the port has neither.  Its dry run
(`launch/dryrun.py`) counts the per-chip step itself (FLOPs with
`torch.utils.flop_counter.FlopCounterMode`, bytes as operand + result
bytes of every op) and computes each collective leaf by leaf from the
sharding plan; `analyze` takes those counters.  `wire_bytes` holds the
ring-algorithm estimates of per-chip wire bytes that the reference's HLO
parser applies:

    all-gather      (g-1)/g * result_bytes        (recv per chip)
    reduce-scatter  (g-1)   * result_bytes        (result is the shard)
    all-reduce      2(g-1)/g * operand_bytes
    all-to-all      (g-1)/g * result_bytes
    collective-permute  result_bytes

Hardware constants: NVIDIA's H100 data sheet (SXM part, dense rates
without sparsity): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of
HBM3, and NVLink at 900 GB/s per card in all, 450 GB/s each way.  They are
also read by the layout advisor's step-cost model (`design/advisor.py`).
NVLink joins the cards of one node; a 16x16 mesh spans nodes, whose links
are slower, so the collective term is a lower bound there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12   # dense bf16, tensor cores
HBM_BW = 3.35e12      # bytes/s, HBM3
LINK_BW = 450e9       # bytes/s each way, NVLink
HBM_BYTES = 80e9      # one card's device memory

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Per-chip wire bytes of one collective of `kind` over a group of
    `group` chips moving `nbytes` (the result's bytes; the operand's for
    all-reduce).  0 for a group of one."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}")
    if group <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (group - 1) / group
    if kind == "reduce-scatter":
        return nbytes * (group - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (group - 1) / group
    if kind == "all-to-all":
        return nbytes * (group - 1) / group
    return nbytes                                   # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes_per_chip: float = 0.0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, b: float):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + b
        self.wire_bytes_per_chip += b

    def collective(self, kind: str, nbytes: float, group: int) -> None:
        """Count one collective of `kind` moving `nbytes` over `group`
        chips; a group of one moves nothing and is not counted."""
        if group > 1:
            self.add(kind, wire_bytes(kind, nbytes, group))


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    n_devices: int
    collectives: Dict[str, int]

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time if terms overlap perfectly."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def summary(self) -> Dict[str, float]:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
        }


def analyze(flops: float, hbm_bytes: float, collectives: CollectiveStats,
            n_devices: int) -> Roofline:
    """Roofline terms of the dry run's per-chip counters."""
    return Roofline(flops_per_chip=float(flops),
                    hbm_bytes_per_chip=float(hbm_bytes),
                    wire_bytes_per_chip=collectives.wire_bytes_per_chip,
                    n_devices=n_devices, collectives=dict(collectives.counts))


def model_flops(cfg, shape_info: Dict) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), D = tokens."""
    n = cfg.param_count()
    if cfg.moe is not None:
        moe = cfg.moe
        # active experts fraction of the MoE weights
        e_all = moe.n_experts
        moe_frac = moe.top_k / e_all
        if cfg.hybrid is not None:
            n_moe_layers = cfg.n_layers // 2
        else:
            n_moe_layers = cfg.n_layers // moe.every_k_layers
        moe_params = n_moe_layers * (e_all * 3 * cfg.d_model
                                     * moe.d_ff_expert)
        n = n - moe_params + moe_params * moe_frac
    kind = shape_info["kind"]
    if kind == "train":
        tokens = shape_info["batch"] * shape_info["seq"]
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape_info["batch"] * shape_info["seq"]
        return 2.0 * n * tokens
    # decode: one token per request
    return 2.0 * n * shape_info["batch"]
