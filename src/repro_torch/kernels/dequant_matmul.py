"""Fused dequantize-matmul (decompress on read).

    out (M, N) = a (M, K) @ dequant(qw (K, N) int8, scale (K / block, N))

The weight stays int8 in memory with one float32 scale per (K block,
output column) -- the layout `models.layers.quantize_mlp` produces -- and is
dequantized inside the product: the paper's A.2 rule, "decompress only
what the query reads", fused into the consumer.

* `dequant_matmul(a, qw, scale, block)` -- on a CUDA tensor, the
  hand-written kernel in `csrc/dequant_matmul.cu` (built on first use; any
  M and N, K a multiple of `block`, float32 accumulation on CUDA cores, no
  TF32); on a CPU tensor, the plain version.  There is no other route.
* `dequant_matmul_plain` -- the plain PyTorch version: dequantize the
  whole weight, then one float32 product (`kernels/ref.py`
  `dequant_matmul` of the JAX package).  Its product is IEEE float32 only
  where `torch.backends.cuda.matmul.allow_tf32` is False.

`LAUNCHES` counts kernel launches.  The CUDA kernel replaces the Pallas
kernel `_dequant_matmul_kernel` of the JAX package
(`kernels/dequant_matmul.py`); unlike its wrapper (`kernels/ops.py`), no
dimension has to divide a tile.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build
from .quantize_blockwise import DEFAULT_BLOCK

LAUNCHES: Dict[str, int] = {"dequant_matmul": 0}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("dequant_matmul")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dequant_matmul_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                              vp]
        lib.dequant_matmul_launch.restype = ci
        lib.dequant_matmul_error_string.argtypes = [ci]
        lib.dequant_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(a: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
           block: int) -> None:
    if a.ndim != 2 or qw.ndim != 2 or scale.ndim != 2:
        raise ValueError("dequant_matmul takes a (M, K), qw (K, N) and "
                         "scale (K / block, N)")
    k, n = qw.shape
    if a.shape[1] != k:
        raise ValueError(f"a {tuple(a.shape)} and qw {tuple(qw.shape)} "
                         "disagree on K")
    if block < 1 or k % block:
        raise ValueError(f"K = {k} must be a multiple of block = {block}")
    if tuple(scale.shape) != (k // block, n):
        raise ValueError(f"scale {tuple(scale.shape)} is not "
                         f"{(k // block, n)}")
    if qw.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError("qw must be int8 and scale float32")
    if not (a.device == qw.device == scale.device):
        raise ValueError("all inputs must be on one device")


def dequant_matmul_plain(a: torch.Tensor, qw: torch.Tensor,
                         scale: torch.Tensor, block: int = DEFAULT_BLOCK
                         ) -> torch.Tensor:
    _check(a, qw, scale, block)
    k, n = qw.shape
    w = qw.to(torch.float32).reshape(k // block, block, n) * scale[:, None, :]
    return a.to(torch.float32) @ w.reshape(k, n)


def dequant_matmul(a: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                   block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """a (M, K) @ dequant(qw (K, N)) with per-(K block, N) scales -> (M, N)
    float32."""
    _check(a, qw, scale, block)
    if a.device.type == "cpu":
        return dequant_matmul_plain(a, qw, scale, block)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if block % 32:
        raise ValueError(f"the kernel takes a block that is a multiple of "
                         f"32, got {block}")
    m, k = a.shape
    n = qw.shape[1]
    if max(m * k, k * n, m * n) >= 2 ** 31 or m >= 64 * 65535:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(qw.shape)} "
                         "outside the kernel's sizes")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    a = a.to(torch.float32).contiguous()
    qw, scale = qw.contiguous(), scale.contiguous()
    err = _load().dequant_matmul_launch(
        a.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n,
        k, block, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        msg = _load().dequant_matmul_error_string(err).decode()
        raise RuntimeError(f"dequant_matmul launch failed: {msg} "
                           f"(CUDA error {err})")
    LAUNCHES["dequant_matmul"] += 1
    return out
