"""RWKV6 "Finch" block (arXiv:2404.05892): attention-free time mixing with
data-dependent decay, plus squared-ReLU channel mixing.

Recurrence per head (head size hs, state S in R^{hs x hs}):

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with w_t = exp(-exp(w0 + lora_w(ddlerp_w(x_t, x_{t-1})))) in (0,1), the
data-dependent decay that distinguishes RWKV6 from RWKV4/5.

Serving state per layer: (tm_shift (B,D), cm_shift (B,D), S (B,H,hs,hs)),
O(1) in sequence length.

Counterpart of the JAX package's `models/rwkv.py`, under the same names
and parameter keys (the block is {"tm": ..., "cm": ...}), op for op: the
WKV state is float32 and runs through `layers.chunked_scan`, and the
per-head group norm uses the population variance, as `jnp.var` does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig, RWKVConfig
from .layers import _init, chunked_scan, einsum, mm

MIX_CHANNELS = 5  # w, k, v, r, g


def init_rwkv_block(generator: torch.Generator, cfg: ModelConfig,
                    device=None) -> nn.ModuleDict:
    d = cfg.d_model
    r = cfg.rwkv or RWKVConfig()
    hs = r.head_size
    nh = d // hs

    def init(shape, scale=0.02):
        return _init(generator, shape, scale, device)

    return nn.ModuleDict({
        "tm": nn.ParameterDict({
            # token-shift ddlerp: base mixes + low-rank data-dependent part
            "mu_x": init((d,), 0.5),
            "mu": init((MIX_CHANNELS, d), 0.5),
            "ts_w1": init((d, MIX_CHANNELS * 32)),
            "ts_w2": init((MIX_CHANNELS, 32, d)),
            # data-dependent decay LoRA
            "w0": init((d,), 0.5),
            "w1": init((d, r.decay_lora)),
            "w2": init((r.decay_lora, d)),
            "u": init((nh, hs), 0.5),
            "wr": init((d, d)),
            "wk": init((d, d)),
            "wv": init((d, d)),
            "wg": init((d, d)),
            "wo": init((d, d)),
            "ln_scale": nn.Parameter(torch.ones(d, dtype=torch.float32,
                                                device=device)),
        }),
        "cm": nn.ParameterDict({
            "mu_k": init((d,), 0.5),
            "mu_r": init((d,), 0.5),
            "wk": init((d, cfg.d_ff)),
            "wv": init((cfg.d_ff, d)),
            "wr": init((d, d)),
        }),
    })


def _ddlerp(tm, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp of RWKV6: returns (C=5, ..., D) mixed inputs."""
    xx = x_prev - x
    xxx = x + xx * tm["mu_x"]
    lora = torch.tanh(mm(xxx, tm["ts_w1"]))             # (..., 5*32)
    lora = lora.reshape(*lora.shape[:-1], MIX_CHANNELS, 32)
    dd = einsum("...cr,crd->c...d", lora, tm["ts_w2"])  # (5, ..., D)
    mu = tm["mu"].reshape((MIX_CHANNELS,) + (1,) * (x.ndim - 1) + (-1,))
    return x[None] + xx[None] * (mu + dd)


def _decay(tm, xw: torch.Tensor) -> torch.Tensor:
    w_log = tm["w0"] + mm(torch.tanh(mm(xw, tm["w1"])), tm["w2"])
    return torch.exp(-torch.exp(w_log.to(torch.float32)))  # (0,1)


def _group_norm(y: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Per-head layernorm of the WKV output. y: (..., H, hs)."""
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    out = (y - mean) * torch.rsqrt(var + eps)
    return out.reshape(*y.shape[:-2], -1) * scale


def time_mix_sequence(tm, x: torch.Tensor, cfg: ModelConfig,
                      tm_shift: torch.Tensor, wkv: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D); tm_shift: (B,D) last token of the previous chunk;
    wkv: (B,H,hs,hs).  Returns (out, new_shift, new_wkv)."""
    b, s, d = x.shape
    hs = (cfg.rwkv or RWKVConfig()).head_size
    nh = d // hs
    x_prev = torch.cat([tm_shift.to(x.dtype)[:, None], x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(tm, x, x_prev)         # (B,S,D) each
    w = _decay(tm, xw).reshape(b, s, nh, hs)            # (B,S,H,hs) f32
    k = mm(xk, tm["wk"]).reshape(b, s, nh, hs)
    v = mm(xv, tm["wv"]).reshape(b, s, nh, hs)
    r = mm(xr, tm["wr"]).reshape(b, s, nh, hs)
    g = F.silu(mm(xg, tm["wg"]))
    u = tm["u"][None, :, :, None].to(torch.float32)

    def step(S, inputs):
        wt, kt, vt, rt = inputs                         # (B,H,hs) each
        kv = kt[..., :, None] * vt[..., None, :]        # (B,H,hs,hs)
        y = torch.einsum("bhk,bhkv->bhv", rt, S + u * kv)
        return wt[..., None].to(S.dtype) * S + kv, y

    f32 = torch.float32
    xs = (w.transpose(0, 1), k.transpose(0, 1).to(f32),
          v.transpose(0, 1).to(f32), r.transpose(0, 1).to(f32))
    wkv_new, ys = chunked_scan(step, wkv.to(f32), xs, chunk=256)
    y = ys.transpose(0, 1).to(x.dtype)                  # (B,S,H,hs)
    y = _group_norm(y, tm["ln_scale"].to(x.dtype), cfg.norm_eps)
    out = mm(y * g, tm["wo"])
    return out, x[:, -1].to(tm_shift.dtype), wkv_new.to(wkv.dtype)


def channel_mix_sequence(cm, x: torch.Tensor, cm_shift: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    x_prev = torch.cat([cm_shift.to(x.dtype)[:, None], x[:, :-1]], dim=1)
    xx = x_prev - x
    xk = x + xx * cm["mu_k"]
    xr = x + xx * cm["mu_r"]
    k = torch.square(F.relu(mm(xk, cm["wk"])))
    kv = mm(k, cm["wv"])
    out = torch.sigmoid(mm(xr, cm["wr"])) * kv
    return out, x[:, -1].to(cm_shift.dtype)


def init_rwkv_state(cfg: ModelConfig, batch: int, n_layers: int,
                    dtype=torch.float32, device=None
                    ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    r = cfg.rwkv or RWKVConfig()
    nh = d // r.head_size
    return {
        "tm_shift": torch.zeros((n_layers, batch, d), dtype=dtype,
                                device=device),
        "cm_shift": torch.zeros((n_layers, batch, d), dtype=dtype,
                                device=device),
        "wkv": torch.zeros((n_layers, batch, nh, r.head_size, r.head_size),
                           dtype=torch.float32, device=device),
    }


def rwkv_block(p, x: torch.Tensor, cfg: ModelConfig,
               state: Dict[str, torch.Tensor], norm1, norm2, norm_fn
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full pre-norm RWKV6 block over a sequence (train/prefill/decode-1)."""
    h = norm_fn(norm1, x)
    att, tm_shift, wkv = time_mix_sequence(
        p["tm"], h, cfg, state["tm_shift"], state["wkv"])
    x = x + att
    h = norm_fn(norm2, x)
    ffn, cm_shift = channel_mix_sequence(p["cm"], h, state["cm_shift"])
    x = x + ffn
    return x, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv}
