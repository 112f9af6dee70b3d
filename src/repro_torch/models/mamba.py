"""Mamba-1 selective SSM block (the Jamba hybrid's sequence mixer).

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t      (per channel)
    y_t = C_t . h_t + D x_t

with input-dependent dt (softplus), B, C.  Serving state per layer:
conv ring buffer (B, d_conv-1, d_in) + SSM state (B, d_in, d_state),
O(1) in sequence length.

Counterpart of the JAX package's `models/mamba.py`, under the same names
and parameter keys, op for op: the conv taps are summed first and the
bias added last, the SSM runs in float32 through `layers.chunked_scan`,
and softplus is JAX's `logaddexp(x, 0)`, written out as
max(x, 0) + log1p(exp(-|x|)) (torch's `F.softplus` turns linear above
20 instead).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import HybridConfig, ModelConfig
from .layers import _init, chunked_scan, mm


def d_inner(cfg: ModelConfig) -> int:
    return (cfg.hybrid or HybridConfig()).expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def init_mamba_block(generator: torch.Generator, cfg: ModelConfig,
                     device=None) -> nn.ParameterDict:
    h = cfg.hybrid or HybridConfig()
    d, din, dr, ds = cfg.d_model, d_inner(cfg), dt_rank(cfg), h.d_state

    def const(value, shape):
        return nn.Parameter(torch.full(shape, value, dtype=torch.float32,
                                       device=device))

    a = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=device).expand(din, ds)
    return nn.ParameterDict({
        "in_proj": _init(generator, (d, 2 * din), device=device),
        "conv_w": _init(generator, (h.d_conv, din), 0.2, device),
        "conv_b": const(0.0, (din,)),
        "x_proj": _init(generator, (din, dr + 2 * ds), device=device),
        "dt_w": _init(generator, (dr, din), device=device),
        "dt_b": const(-4.6, (din,)),  # softplus^-1(0.01)
        "a_log": nn.Parameter(torch.log(a).contiguous()),
        "d_skip": const(1.0, (din,)),
        "out_proj": _init(generator, (din, d), device=device),
    })


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jax.nn.softplus` computes it (`logaddexp(x, 0)`)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  x: (B,S,Din); w: (K,Din);
    prev: (B,K-1,Din) carry-in.  Returns (out, new_prev)."""
    k = w.shape[0]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)       # (B,S+K-1,Din)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    return out, xp[:, -(k - 1):] if k > 1 else prev


def mamba_sequence(p, x: torch.Tensor, cfg: ModelConfig,
                   conv_state: torch.Tensor, ssm_state: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D); conv_state: (B,K-1,Din); ssm_state: (B,Din,ds) f32.

    Returns (out (B,S,D), new_conv_state, new_ssm_state)."""
    h = cfg.hybrid or HybridConfig()
    dr, ds = dt_rank(cfg), h.d_state

    xz = mm(x, p["in_proj"])                            # (B,S,2*Din)
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = F.silu(xs)

    proj = mm(xs, p["x_proj"])                          # (B,S,dr+2ds)
    dt, bb, cc = torch.split(proj, [dr, ds, ds], dim=-1)
    dt = softplus(mm(dt, p["dt_w"]) + p["dt_b"])        # (B,S,Din)
    a = -torch.exp(p["a_log"].to(torch.float32))        # (Din,ds)

    dt32 = dt.to(torch.float32)
    da = torch.exp(dt32[..., None] * a)                 # (B,S,Din,ds)
    dbx = (dt32 * xs.to(torch.float32))[..., None] \
        * bb.to(torch.float32)[..., None, :]            # (B,S,Din,ds)

    def step(hst, inputs):
        da_t, dbx_t, c_t = inputs                       # (B,Din,ds)x2,(B,ds)
        hst = da_t * hst + dbx_t
        return hst, torch.einsum("bds,bs->bd", hst, c_t)

    xs_t = (da.transpose(0, 1), dbx.transpose(0, 1),
            cc.to(torch.float32).transpose(0, 1))
    ssm_state, ys = chunked_scan(step, ssm_state.to(torch.float32), xs_t,
                                 chunk=128)
    y = ys.transpose(0, 1).to(x.dtype)                  # (B,S,Din)
    y = y + xs * p["d_skip"]
    y = y * F.silu(z)
    return mm(y, p["out_proj"]), conv_state, ssm_state


def init_mamba_state(cfg: ModelConfig, batch: int, n_layers: int,
                     dtype=torch.float32, device=None
                     ) -> Dict[str, torch.Tensor]:
    h = cfg.hybrid or HybridConfig()
    din = d_inner(cfg)
    return {
        "conv": torch.zeros((n_layers, batch, h.d_conv - 1, din),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((n_layers, batch, din, h.d_state),
                           dtype=torch.float32, device=device),
    }
