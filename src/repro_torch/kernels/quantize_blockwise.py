"""Blockwise int8 quantization ("compression") of a tensor's last dimension.

Blocks of `block` consecutive elements along the last dimension share one
float32 scale = max(absmax, 1e-12) / 127; q = clip(round(x / scale),
-127, 127) with round half to even.  This is the tensor analogue of the
paper's page-local dictionary: the page becomes the quantization block,
the dictionary the scale.

* `quantize_blockwise(x, block)` -- any rank, float32 or bfloat16, any
  last dimension (the ragged last block is masked, which equals the JAX
  package's zero padding).  Returns (q int8 of x's shape, scales float32
  of shape x.shape[:-1] + (ceil(N / block),)).
* `quantize_blockwise_plain` -- the plain PyTorch version of the same
  function.

The wrapper takes its route from the device of its input: on a CUDA
tensor it launches the hand-written kernel in `csrc/quantize_blockwise.cu`
(built on first use) or raises; on a CPU tensor it runs the plain version.
On the card the kernel's q and scales are bit-equal to the plain
version's.  `LAUNCHES` counts kernel launches.

The CUDA kernel replaces the Pallas kernel `_quantize_kernel` of the JAX
package (`kernels/quantize_blockwise.py`); the plain version follows
`kernels/ref.py` `quantize_blockwise` and the any-rank wrapper
`kernels/ops.py` `quantize_blockwise`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import build

DEFAULT_BLOCK = 128
Q_MAX = 127.0

LAUNCHES: Dict[str, int] = {"quantize_blockwise": 0}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("quantize_blockwise")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quantize_blockwise_launch.argtypes = [vp, vp, vp, cll, ci, ci,
                                                  ci, vp]
        lib.quantize_blockwise_launch.restype = ci
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
