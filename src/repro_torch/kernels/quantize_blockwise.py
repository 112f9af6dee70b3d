"""Blockwise int8 quantization ("compression") of a tensor's last
dimension, and its inverse.

Blocks of `block` consecutive elements along the last dimension share one
float32 scale = max(absmax, 1e-12) / 127; q = clip(round(x / scale),
-127, 127) with round half to even.  This is the tensor analogue of the
paper's page-local dictionary: the page becomes the quantization block,
the dictionary the scale.

* `quantize_blockwise(x, block)` -- any rank, float32 or bfloat16, any
  last dimension (the ragged last block is masked, which equals the JAX
  package's zero padding).  Returns (q int8 of x's shape, scales float32
  of shape x.shape[:-1] + (ceil(N / block),)).
* `dequantize_blockwise(q, scales, block, dtype)` -- the inverse: q *
  scale of its block, one float32 multiply, cast to `dtype` (float32 or
  bfloat16); any rank, any last dimension.
* `quantize_blockwise_plain`, `dequantize_blockwise_plain` -- the plain
  PyTorch versions of the same functions.

Each wrapper takes its route from the device of its input: on a CUDA
tensor it launches its hand-written kernel in `csrc/quantize_blockwise.cu`
(one library, built on first use) or raises; on a CPU tensor it runs the
plain version.  On the card the kernels' results are bit-equal to the
plain versions'.  `LAUNCHES` counts kernel launches, per wrapper.

The CUDA kernels replace the Pallas kernels `_quantize_kernel` and
`_dequantize_kernel` of the JAX package (`kernels/quantize_blockwise.py`);
the plain versions follow `kernels/ref.py` `quantize_blockwise` /
`dequantize_blockwise` and the any-rank wrappers of `kernels/ops.py`.
The q8 codec of the LM stack runs through them: `quantize_mlp` (serving),
the q8 gradient wire (`train/step.py`) and the q8 AdamW moments
(`optim/adamw.py`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import build

DEFAULT_BLOCK = 128
Q_MAX = 127.0

LAUNCHES: Dict[str, int] = {"quantize_blockwise": 0, "dequantize_blockwise": 0}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("quantize_blockwise")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quantize_blockwise_launch.argtypes = [vp, vp, vp, cll, ci, ci,
                                                  ci, vp]
        lib.quantize_blockwise_launch.restype = ci
        lib.dequantize_blockwise_launch.argtypes = [vp, vp, vp, cll, ci, ci,
                                                    ci, ci, vp]
        lib.dequantize_blockwise_launch.restype = ci
        lib.quantize_error_string.argtypes = [ci]
        lib.quantize_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def quantize_blockwise_plain(x: torch.Tensor, block: int = DEFAULT_BLOCK
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., N) -> (q int8 (..., N), scales f32 (..., ceil(N/block)))."""
    n = x.shape[-1]
    pad = (-n) % block
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, pad))
    blocks = xp.reshape(*xp.shape[:-1], xp.shape[-1] // block, block)
    absmax = blocks.abs().amax(dim=-1)
    # a tensor divisor: on CUDA, PyTorch turns division by a Python scalar
    # into multiplication by its reciprocal, which rounds differently
    scale = absmax.clamp_min(1e-12) / torch.full_like(absmax, Q_MAX)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -Q_MAX, Q_MAX)
    q = q.to(torch.int8).reshape(xp.shape)[..., :n]
    return q, scale


def quantize_blockwise(x: torch.Tensor, block: int = DEFAULT_BLOCK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-rank blockwise int8 quantization of the last dimension."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_blockwise takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if x.ndim < 1 or block < 1:
        raise ValueError("quantize_blockwise needs a last dimension and "
                         "block >= 1")
    if x.device.type == "cpu":
        return quantize_blockwise_plain(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[-1]
    nb = -(-n // block)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*x.shape[:-1], nb), dtype=torch.float32,
                         device=x.device)
    rows = x.numel() // n if n else 0
    if rows == 0:
        return q, scales
    if n >= 2 ** 31 or rows * nb >= 2 ** 34:   # grid of rows*nb/8 blocks
        raise ValueError(f"shape {tuple(x.shape)} outside the kernel's "
                         "sizes")
    x = x.contiguous()
    err = _load().quantize_blockwise_launch(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), rows, n, block,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = _load().quantize_error_string(err).decode()
        raise RuntimeError(f"quantize_blockwise launch failed: {msg} "
                           f"(CUDA error {err})")
    LAUNCHES["quantize_blockwise"] += 1
    return q, scales


def _check_dequantize(q: torch.Tensor, scales: torch.Tensor, block: int,
                      dtype: torch.dtype) -> None:
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"dequantize_blockwise takes int8 q and float32 "
                         f"scales, got {q.dtype} and {scales.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dequantize_blockwise gives float32 or bfloat16, "
                         f"not {dtype}")
    if q.ndim < 1 or block < 1:
        raise ValueError("dequantize_blockwise needs a last dimension and "
                         "block >= 1")
    want = (*q.shape[:-1], -(-q.shape[-1] // block))
    if tuple(scales.shape) != want:
        raise ValueError(f"scales {tuple(scales.shape)} do not fit q "
                         f"{tuple(q.shape)} at block {block}: want {want}")
    if scales.device != q.device:
        raise ValueError(f"q on {q.device}, scales on {scales.device}")


def dequantize_blockwise_plain(q: torch.Tensor, scales: torch.Tensor,
                               block: int = DEFAULT_BLOCK,
                               dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """Inverse of quantize_blockwise: q (..., N) int8, scales (...,
    ceil(N/block)) -> (..., N) in `dtype`."""
    _check_dequantize(q, scales, block, dtype)
    n = q.shape[-1]
    qp = torch.nn.functional.pad(q, (0, (-n) % block))
    blocks = qp.reshape(*qp.shape[:-1], qp.shape[-1] // block, block)
    out = blocks.to(torch.float32) * scales[..., None]
    return out.reshape(qp.shape)[..., :n].to(dtype)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         block: int = DEFAULT_BLOCK,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Any-rank blockwise dequantization of the last dimension."""
    if q.device.type == "cpu":
        return dequantize_blockwise_plain(q, scales, block, dtype)
    _check_dequantize(q, scales, block, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    n = q.shape[-1]
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    total = q.numel()
    if total == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} outside the kernel's "
                         "sizes")
    q, scales = q.contiguous(), scales.contiguous()
    # the 4-wide path: 4 consecutive elements share a row and a block, q's
    # char4 load is aligned (a fresh output always is)
    vec = n % 4 == 0 and block % 4 == 0 and q.data_ptr() % 4 == 0
    err = _load().dequantize_blockwise_launch(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), total, n, block,
        int(dtype == torch.bfloat16), int(vec),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = _load().quantize_error_string(err).decode()
        raise RuntimeError(f"dequantize_blockwise launch failed: {msg} "
                           f"(CUDA error {err})")
    LAUNCHES["dequantize_blockwise"] += 1
    return out
