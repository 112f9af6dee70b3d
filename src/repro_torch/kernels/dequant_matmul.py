"""Fused dequantize-matmul (decompress on read).

    out (M, N) = a (M, K) @ dequant(qw (K, N) int8, scale (K / block, N))

The weight stays int8 in memory with one float32 scale per (K block,
output column) -- the layout `models.layers.quantize_mlp` produces -- and is
dequantized inside the product: the paper's A.2 rule, "decompress only
what the query reads", fused into the consumer.

* `dequant_matmul(a, qw, scale, block)` -- on a CUDA tensor, the
  hand-written kernels in `csrc/dequant_matmul.cu` (built on first use):
  a split-K decode kernel on the CUDA cores for M up to the source's
  `kDecodeMaxM`, a bf16 tensor-core kernel (a split into hi + lo terms)
  above it; any M and N, K a multiple of `block`, float32 accumulation, no
  TF32.  On a CPU tensor, the plain version.  There is no other route.
* `dequant_matmul_plain` -- the plain PyTorch version: dequantize the
  whole weight, then one float32 product (`kernels/ref.py`
  `dequant_matmul` of the JAX package).  Its product is IEEE float32 only
  where `torch.backends.cuda.matmul.allow_tf32` is False.

`LAUNCHES` counts calls that launch the kernels (one per call: the decode
route's split-K sum is its second launch).  The CUDA kernels replace the
Pallas kernel `_dequant_matmul_kernel` of the JAX package
(`kernels/dequant_matmul.py`); unlike its wrapper (`kernels/ops.py`), no
dimension has to divide a tile.  Both kernels multiply each K block's
product by its scale row once, sum(a * q) * s, which rounds differently
from the plain a @ (q * s); the result is held within rtol and atol 1e-4
of the plain version, and two calls give the same bits (the split-K
reduction runs in a fixed order, without atomics).  On the decode route
the result is a view of the head of a buffer that also holds the split-K
partials, 1 + K / block times its size.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build
from .quantize_blockwise import DEFAULT_BLOCK

LAUNCHES: Dict[str, int] = {"dequant_matmul": 0}

_lib = None
_decode_max_m = 0   # the source's kDecodeMaxM, read when the library loads


def _load():
    global _lib, _decode_max_m
    if _lib is None:
        lib = build.load("dequant_matmul")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dequant_matmul_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                              ci, ci, vp]
        lib.dequant_matmul_launch.restype = ci
        lib.dequant_matmul_decode_max_m.argtypes = []
        lib.dequant_matmul_decode_max_m.restype = ci
        lib.dequant_matmul_error_string.argtypes = [ci]
        lib.dequant_matmul_error_string.restype = ctypes.c_char_p
        _decode_max_m = lib.dequant_matmul_decode_max_m()
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
    if scale.shape != (k // block, n):
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
    if not a.is_cuda:
        if a.device.type == "cpu":
            return dequant_matmul_plain(a, qw, scale, block)
        raise ValueError(f"unsupported device {a.device}")
    if block % 32:
        raise ValueError(f"the kernel takes a block that is a multiple of "
                         f"32, got {block}")
    m, k = a.shape
    n = qw.shape[1]
    if max(m * k, k * n, m * n) >= 2 ** 31 or m >= 64 * 65535 \
            or k // block > 65535:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(qw.shape)} "
                         "outside the kernel's sizes")
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _load()
    if a.dtype != torch.float32 or not a.is_contiguous():
        a = a.to(torch.float32).contiguous()
    if a.data_ptr() % 16:       # the tensor-core kernel copies 16-byte rows
        a = a.clone()
    qw, scale = qw.contiguous(), scale.contiguous()
    # the decode kernel's split-K partials, (K / block, M, N), follow the
    # output in one allocation (`out` is a view of its head)
    nws = (k // block) * m * n if m <= _decode_max_m and k > block else 0
    buf = torch.empty(m * n + nws, dtype=torch.float32, device=a.device)
    out = buf[:m * n].view(m, n)
    vec = n % 16 == 0 and qw.data_ptr() % 16 == 0
    err = lib.dequant_matmul_launch(
        a.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
        buf.data_ptr() + 4 * m * n if nws else None, m, n, k, block,
        int(vec), torch._C._cuda_getCurrentRawStream(a.get_device()))
    if err != 0:
        msg = lib.dequant_matmul_error_string(err).decode()
        raise RuntimeError(f"dequant_matmul launch failed: {msg} "
                           f"(CUDA error {err})")
    LAUNCHES["dequant_matmul"] += 1
    return out
