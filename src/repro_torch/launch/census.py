"""Analytic op census: FLOPs / HBM bytes / collective bytes per chip.

Counterpart of the JAX package's `launch/census.py`, the same formulas.
It exists there because XLA's `cost_analysis()` counts a scanned layer
stack's body once; the port's dry run counts its own step with
`torch.utils.flop_counter.FlopCounterMode` (`launch/dryrun.py`), and the
census is the analytic number beside it: matmul-exact FLOPs, standard
operand + result accounting for HBM, sharding-derived collective volumes.
`tests/test_torch_census.py` holds it field by field to the reference's
and its forward FLOPs to `FlopCounterMode` on small configs.

All numbers are per chip per step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..models import mamba as M
from ..models.config import ModelConfig


@dataclasses.dataclass
class Census:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    detail: Dict[str, float]


def _attn_layer_flops(cfg, b, s, ctx, decode: bool) -> float:
    d, nh, nkv, hd = cfg.d_model, cfg.heads, cfg.kv_heads, cfg.d_head
    toks = b * (1 if decode else s)
    proj = 2.0 * toks * d * (nh + 2 * nkv + nh) * hd     # QKV + O
    if decode:
        attn = 4.0 * b * ctx * nh * hd                   # QK^T + PV
    else:
        attn = 0.5 * 4.0 * b * s * s * nh * hd           # causal half
    return proj + attn


def _mlp_layer_flops(cfg, toks) -> float:
    mult = 3.0 if cfg.mlp == "swiglu" else 2.0
    return 2.0 * toks * mult * cfg.d_model * cfg.d_ff


def _moe_layer_flops(cfg, toks) -> float:
    moe = cfg.moe
    router = 2.0 * toks * cfg.d_model * moe.experts
    expert = 2.0 * toks * moe.top_k * moe.capacity_factor \
        * 3.0 * cfg.d_model * moe.d_ff_expert
    return router + expert


def _rwkv_layer_flops(cfg, toks) -> float:
    d = cfg.d_model
    r = cfg.rwkv
    hs = r.head_size
    proj = 2.0 * toks * d * d * 5                         # r,k,v,g,o
    lora = 2.0 * toks * d * (5 * 32 + 2 * r.decay_lora)
    wkv = 6.0 * toks * d * hs                             # kv, y, decay-update
    cm = 2.0 * toks * (2 * d * cfg.d_ff + d * d)
    return proj + lora + wkv + cm


def _mamba_layer_flops(cfg, toks) -> float:
    d = cfg.d_model
    h = cfg.hybrid
    din = M.d_inner(cfg)
    dr = M.dt_rank(cfg)
    proj = 2.0 * toks * d * 2 * din + 2.0 * toks * din * d
    xproj = 2.0 * toks * din * (dr + 2 * h.d_state) + 2.0 * toks * dr * din
    conv = 2.0 * toks * h.d_conv * din
    scan = 6.0 * toks * din * h.d_state                   # h update + y
    return proj + xproj + conv + scan


def forward_flops(cfg: ModelConfig, b: int, s: int, ctx: int,
                  decode: bool) -> Dict[str, float]:
    toks = b * (1 if decode else s)
    out: Dict[str, float] = {}
    if cfg.hybrid is not None:
        g = cfg.hybrid
        n_groups = cfg.n_layers // g.group_size
        n_attn = n_groups
        n_mamba = cfg.n_layers - n_attn
        n_moe = cfg.n_layers // 2
        n_mlp = cfg.n_layers - n_moe
        out["attn"] = n_attn * _attn_layer_flops(cfg, b, s, ctx, decode)
        out["mamba"] = n_mamba * _mamba_layer_flops(cfg, toks)
        out["moe"] = n_moe * _moe_layer_flops(cfg, toks)
        out["mlp"] = n_mlp * _mlp_layer_flops(cfg, toks)
    elif cfg.mixer == "rwkv6":
        out["rwkv"] = cfg.n_layers * _rwkv_layer_flops(cfg, toks)
    else:
        out["attn"] = cfg.n_layers * _attn_layer_flops(cfg, b, s, ctx, decode)
        if cfg.moe is not None:
            out["moe"] = cfg.n_layers * _moe_layer_flops(cfg, toks)
        else:
            out["mlp"] = cfg.n_layers * _mlp_layer_flops(cfg, toks)
    out["head"] = 2.0 * toks * cfg.d_model * cfg.vocab_p
    return out


def census(cfg: ModelConfig, kind: str, batch: int, seq: int,
           n_chips: int, tp: int = 16,
           param_bytes: float = 2.0, remat: bool = True,
           grad_compression: Optional[str] = None,
           pod_dp: int = 1, kv_bytes_per_elem: Optional[float] = None
           ) -> Census:
    """Per-chip census for one cell.

    kind: train | prefill | decode.  For decode, seq is the KV length.
    n_chips = tp * dp (* pod_dp); activations shard over dp, weights over
    tp x dp (FSDP), collectives per DESIGN.md §5.
    """
    decode = kind == "decode"
    kvb = param_bytes if kv_bytes_per_elem is None else kv_bytes_per_elem
    b, s, ctx = batch, (1 if decode else seq), seq
    fwd = forward_flops(cfg, b, s if not decode else seq, ctx, decode)
    fwd_total = sum(fwd.values())
    if kind == "train":
        # bwd = 2x fwd; remat adds ~1x fwd recompute; optimizer ~10/param
        n_params = cfg.param_count(padded=True)
        flops_total = fwd_total * (4.0 if remat else 3.0) + 10.0 * n_params
    else:
        flops_total = fwd_total
    flops_chip = flops_total / n_chips

    # ---- HBM bytes (per chip) ----
    n_params = cfg.param_count(padded=True)
    d = cfg.d_model
    toks_local = b * s / (n_chips / tp)   # activations shard over dp axes
    act_unit = toks_local * d * 2.0       # one (B_local, S, D) bf16 tensor
    # per layer: ~6 activation tensor traversals fwd, ~12 bwd (+recompute)
    act_traffic = cfg.n_layers * act_unit * (18 if kind == "train" else 6)
    if kind == "train":
        # params: bf16 read fwd+bwd(+remat) + f32 master read/write +
        # grads f32 write/read + adam moments read+write (f32)
        pbytes = n_params / n_chips * (2 * 3 + 4 * 2 + 4 * 2 + 8 * 2)
    else:
        pbytes = n_params / n_chips * param_bytes
    kv_bytes = 0.0
    if decode:
        if cfg.hybrid is not None or cfg.mixer == "attn":
            # whole cache read once per step; sharded over dp (batch) x tp
            # (kv heads) => /n_chips
            n_attn = cfg.attn_layers
            kv_bytes = 2.0 * n_attn * b * seq * cfg.kv_heads * cfg.d_head \
                * kvb / n_chips
        if cfg.mixer == "rwkv6":
            r = cfg.rwkv
            nh = d // r.head_size
            kv_bytes = 2.0 * cfg.n_layers * b * nh * r.head_size ** 2 * 4.0 \
                / n_chips
        if cfg.hybrid is not None:
            din = M.d_inner(cfg)
            kv_bytes += 2.0 * (cfg.n_layers - cfg.attn_layers) * b * din \
                * (cfg.hybrid.d_state + cfg.hybrid.d_conv - 1) * 4.0 / n_chips
    hbm = act_traffic + pbytes + kv_bytes

    # ---- collective bytes (per chip wire) ----
    dp = n_chips // tp // pod_dp
    wire = 0.0
    detail = dict(fwd)
    if kind == "train":
        # FSDP all-gather of bf16 params over dp: fwd + bwd
        wire += 2.0 * (n_params / n_chips) * 2.0 * (dp - 1)
        # gradient reduce-scatter over dp (+ all-reduce over pods)
        gbytes = 1.0 if grad_compression == "q8" else 4.0
        wire += (n_params / n_chips) * gbytes * (dp - 1)
        if pod_dp > 1:
            wire += 2.0 * (n_params / (n_chips / pod_dp)) * gbytes \
                * (pod_dp - 1) / pod_dp
    # TP all-reduce of layer outputs (attn + mlp) over tp
    n_ar = 2 * cfg.n_layers * (3 if kind == "train" else 1)
    wire += n_ar * (toks_local * d * 2.0) * 2.0 * (tp - 1) / tp
    detail.update({"act_traffic": act_traffic, "param_bytes_hbm": pbytes,
                   "kv_bytes": kv_bytes})
    return Census(flops=flops_chip, hbm_bytes=hbm, wire_bytes=wire,
                  detail=detail)
