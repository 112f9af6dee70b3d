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
* `quantize_kv(x, block)` -- the same scheme over a KV cache's head
  dimension.
* `quantize_blockwise_group(items, block)` -- the same for a list of (x,
  q, scales) triples, written into each q and scales, in one launch per
  `group_capacity()` items.
* `dequantize_blockwise(q, scales, block, dtype)` -- the inverse: q *
  scale of its block, one float32 multiply, cast to `dtype` (float32 or
  bfloat16); any rank, any last dimension.
* `dequantize_blockwise_group(items, block)` -- the same for a list of
  (q, scales, out) triples, written into each `out` (its dtype, float32 or
  bfloat16, is the output type) in one launch per `group_capacity()`
  items.
* `quantize_blockwise_plain`, `quantize_blockwise_group_plain`,
  `dequantize_blockwise_plain`, `dequantize_blockwise_group_plain` -- the
  plain PyTorch versions of the same functions.

Each wrapper takes its route from the device of its input: on a CUDA
tensor it launches its hand-written kernel in `csrc/quantize_blockwise.cu`
(one library, built on first use) or raises; on a CPU tensor it runs the
plain version.  On the card the kernels' results are bit-equal to the
plain versions'.  `LAUNCHES` counts kernel launches, per kernel (a single
call is a one-item group: the single and the grouped quantize count
under "quantize_blockwise", the two dequantizes under
"dequantize_blockwise").

The CUDA kernels replace the Pallas kernels `_quantize_kernel` and
`_dequantize_kernel` of the JAX package (`kernels/quantize_blockwise.py`);
the plain versions follow `kernels/ref.py` `quantize_blockwise` /
`dequantize_blockwise` and the any-rank wrappers of `kernels/ops.py`.
The q8 codec of the LM stack runs through them: `quantize_mlp` (serving,
single calls), the q8 gradient wire (`train/step.py`, a grouped quantize
and a grouped dequantize per bucket) and the q8 AdamW moments
(`optim/adamw.py`, m and sqrt(v) of a parameter as one two-item group
each way).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from . import build

DEFAULT_BLOCK = 128
Q_MAX = 127.0
_MAX_ITEM = 2 ** 31     # a kernel item holds fewer elements

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
                                                    ci, vp]
        lib.dequantize_blockwise_launch.restype = ci
        for fn in (lib.quantize_group_launch, lib.dequantize_group_launch):
            fn.argtypes = [vp, ci, ci, vp]
            fn.restype = ci
        lib.dequantize_group_capacity.argtypes = []
        lib.dequantize_group_capacity.restype = ci
        lib.quantize_error_string.argtypes = [ci]
        lib.quantize_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _stream(index: int) -> int:
    """The handle of CUDA device `index`'s current stream, without building
    a `torch.cuda.Stream`."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch_check(err: int, what: str) -> None:
    if err != 0:
        msg = _load().quantize_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (CUDA error {err})")


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
    """Any-rank blockwise int8 quantization of the last dimension: the
    grouped kernel on a one-item list, on a CUDA tensor."""
    _check_quantize_input(x, block)
    if x.device.type == "cpu":
        return quantize_blockwise_plain(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[-1]
    nb = -(-n // block)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*x.shape[:-1], nb), dtype=torch.float32,
                         device=x.device)
    total = x.numel()
    if total == 0:
        return q, scales
    x = x.contiguous()
    if total >= _MAX_ITEM:          # split by rows: a grouped launch
        _launch_group(_quantize_rows(x, q, scales, block), block,
                      x.get_device(), "quantize_blockwise")
        return q, scales
    err = _load().quantize_blockwise_launch(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), total // n, n, block,
        int(x.dtype == torch.bfloat16), _stream(x.get_device()))
    _launch_check(err, "quantize_blockwise")
    LAUNCHES["quantize_blockwise"] += 1
    return q, scales


def quantize_kv(x: torch.Tensor, block: int = DEFAULT_BLOCK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cache quantization: `quantize_blockwise`'s scheme over the head
    dimension (a head dimension below `block` is one masked block, as the
    JAX package's zero padding)."""
    return quantize_blockwise(x, block)


def _check_quantize_input(x: torch.Tensor, block: int) -> None:
    if x.dtype is not torch.float32 and x.dtype is not torch.bfloat16:
        raise ValueError(f"quantize_blockwise takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if x.ndim < 1 or block < 1:
        raise ValueError("quantize_blockwise needs a last dimension and "
                         "block >= 1")


def _check_dequantize(q: torch.Tensor, scales: torch.Tensor, block: int,
                      dtype: torch.dtype) -> None:
    # plain ints, `is` on the dtype singletons and no new torch.Size: a
    # single call at a small shape is host work, and this runs on every one
    if q.dtype is not torch.int8 or scales.dtype is not torch.float32:
        raise ValueError(f"dequantize_blockwise takes int8 q and float32 "
                         f"scales, got {q.dtype} and {scales.dtype}")
    if dtype is not torch.float32 and dtype is not torch.bfloat16:
        raise ValueError(f"dequantize_blockwise gives float32 or bfloat16, "
                         f"not {dtype}")
    qs, ss = q.shape, scales.shape
    nd = len(qs)
    if nd == 0 or block < 1:
        raise ValueError("dequantize_blockwise needs a last dimension and "
                         "block >= 1")
    fits = len(ss) == nd and ss[-1] == -(-qs[-1] // block)
    for i in range(nd - 1):
        fits = fits and qs[i] == ss[i]
    if not fits:
        want = (*qs[:-1], -(-qs[-1] // block))
        raise ValueError(f"scales {tuple(ss)} do not fit q {tuple(qs)} at "
                         f"block {block}: want {want}")
    if scales.get_device() != q.get_device():
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
    """Any-rank blockwise dequantization of the last dimension: the
    grouped kernel on a one-item list, on a CUDA tensor."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            return dequantize_blockwise_plain(q, scales, block, dtype)
        raise ValueError(f"unsupported device {q.device}")
    _check_dequantize(q, scales, block, dtype)
    if not q.is_contiguous():
        q = q.contiguous()
    if not scales.is_contiguous():
        scales = scales.contiguous()
    out = torch.empty_like(q, dtype=dtype)      # contiguous, like q
    n = q.shape[-1]
    total = out.numel()
    if total == 0:
        return out
    if total >= _MAX_ITEM:          # split by rows: a grouped launch
        _launch_group(_table_rows(q, scales, out, block), block,
                      q.get_device())
        return out
    err = _load().dequantize_blockwise_launch(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), total // n, n,
        block, dtype is torch.bfloat16, _stream(q.get_device()))
    _launch_check(err, "dequantize_blockwise")
    LAUNCHES["dequantize_blockwise"] += 1
    return out


def _row_runs(n: int, rows: int):
    """(first row, rows) runs of whole rows of fewer than 2^31 elements
    each: the kernel items of a tensor of `rows` rows of `n`."""
    if n >= _MAX_ITEM:
        raise ValueError(f"a last dimension of {n} is outside the kernel's "
                         "sizes")
    step = (_MAX_ITEM - 1) // n
    return [(r, min(step, rows - r)) for r in range(0, rows, step)]


def _table_rows(q: torch.Tensor, scales: torch.Tensor, out: torch.Tensor,
                block: int):
    """The dequantize kernel's table rows (q, scales, out addresses, rows,
    n, out_bf16) for contiguous q, scales and out: one row, or one per run
    of rows of fewer than 2^31 elements."""
    n = q.shape[-1]
    nb = -(-n // block)
    es = out.element_size()
    return [(q.data_ptr() + r * n, scales.data_ptr() + r * nb * 4,
             out.data_ptr() + r * n * es, k, n,
             int(out.dtype == torch.bfloat16))
            for r, k in _row_runs(n, q.numel() // n)]


def _quantize_rows(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                   block: int):
    """The quantize kernel's table rows (x, q, scales addresses, rows, n,
    x_bf16) for contiguous x, q and scales, split as `_table_rows`."""
    n = x.shape[-1]
    nb = -(-n // block)
    es = x.element_size()
    return [(x.data_ptr() + r * n * es, q.data_ptr() + r * n,
             scales.data_ptr() + r * nb * 4, k, n,
             int(x.dtype == torch.bfloat16))
            for r, k in _row_runs(n, x.numel() // n)]


def _launch_group(table, block: int, device_index: int,
                  what: str = "dequantize_blockwise") -> None:
    """One grouped launch of `what`'s kernel ("quantize_blockwise" or
    "dequantize_blockwise") per `group_capacity()` rows of `table`."""
    lib = _load()
    launch = (lib.quantize_group_launch if what == "quantize_blockwise"
              else lib.dequantize_group_launch)
    cap = lib.dequantize_group_capacity()
    stream = _stream(device_index)
    for i in range(0, len(table), cap):
        chunk = table[i:i + cap]
        flat = (ctypes.c_longlong * (6 * len(chunk)))(
            *(v for row in chunk for v in row))
        err = launch(flat, len(chunk), block, stream)
        _launch_check(err, f"{what}_group")
        LAUNCHES[what] += 1


Group = Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _check_group(items: Group, block: int) -> None:
    for q, scales, out in items:
        _check_dequantize(q, scales, block, out.dtype)
        if out.shape != q.shape or out.device != q.device:
            raise ValueError(f"out {tuple(out.shape)} on {out.device} does "
                             f"not match q {tuple(q.shape)} on {q.device}")
        if not out.is_contiguous():
            raise ValueError("dequantize_blockwise_group writes into "
                             "contiguous outputs only")
        if q.device != items[0][0].device:
            raise ValueError("a dequantize group spans devices "
                             f"{items[0][0].device} and {q.device}")


def dequantize_blockwise_group_plain(items: Group,
                                     block: int = DEFAULT_BLOCK) -> None:
    """`dequantize_blockwise_plain` of each (q, scales, out), written into
    out in out's dtype."""
    _check_group(items, block)
    for q, scales, out in items:
        out.copy_(dequantize_blockwise_plain(q, scales, block, out.dtype))


def group_capacity() -> int:
    """The most items one grouped quantize or dequantize launch takes (the
    kernels' parameter structs; a tensor of 2^31 elements or more takes
    more than one)."""
    return _load().dequantize_group_capacity()


def dequantize_blockwise_group(items: Group,
                               block: int = DEFAULT_BLOCK) -> None:
    """Blockwise dequantization of every (q, scales, out) of `items` into
    its out (float32 or bfloat16), any ranks and last dimensions.  On CUDA
    tensors: one kernel launch per `group_capacity()` items; on CPU
    tensors: the plain version."""
    items = list(items)
    if not items:
        return
    if items[0][0].device.type == "cpu":
        dequantize_blockwise_group_plain(items, block)
        return
    _check_group(items, block)
    if items[0][0].device.type != "cuda":
        raise ValueError(f"unsupported device {items[0][0].device}")
    table, held = [], []
    for q, scales, out in items:
        if q.numel() == 0:
            continue
        q, scales = q.contiguous(), scales.contiguous()
        held.append((q, scales))       # alive until the launches are queued
        table += _table_rows(q, scales, out, block)
    _launch_group(table, block, items[0][0].get_device())


def _check_quantize_group(items: Group, block: int) -> None:
    device = items[0][0].device
    for x, q, scales in items:
        _check_quantize_input(x, block)
        want = (*x.shape[:-1], -(-x.shape[-1] // block))
        if q.dtype is not torch.int8 or q.shape != x.shape:
            raise ValueError(f"q {q.dtype} {tuple(q.shape)} is not int8 of "
                             f"x's shape {tuple(x.shape)}")
        if scales.dtype is not torch.float32 or tuple(scales.shape) != want:
            raise ValueError(f"scales {scales.dtype} {tuple(scales.shape)} "
                             f"do not fit x {tuple(x.shape)} at block "
                             f"{block}: want float32 {want}")
        if not (q.is_contiguous() and scales.is_contiguous()):
            raise ValueError("quantize_blockwise_group writes into "
                             "contiguous q and scales only")
        if not x.device == q.device == scales.device == device:
            raise ValueError(f"a quantize group spans devices {device}, "
                             f"{x.device}, {q.device} and {scales.device}")


def quantize_blockwise_group_plain(items: Group,
                                   block: int = DEFAULT_BLOCK) -> None:
    """`quantize_blockwise_plain` of each (x, q, scales), written into q
    and scales."""
    items = list(items)
    if not items:
        return
    _check_quantize_group(items, block)
    for x, q, scales in items:
        got_q, got_s = quantize_blockwise_plain(x, block)
        q.copy_(got_q)
        scales.copy_(got_s)


def quantize_blockwise_group(items: Group,
                             block: int = DEFAULT_BLOCK) -> None:
    """Blockwise int8 quantization of every (x, q, scales) of `items` into
    its q (int8, x's shape) and scales (float32, x.shape[:-1] +
    (ceil(N / block),)); x float32 or bfloat16, any ranks and last
    dimensions.  On CUDA tensors: one kernel launch per `group_capacity()`
    items; on CPU tensors: the plain version."""
    items = list(items)
    if not items:
        return
    if items[0][0].device.type == "cpu":
        quantize_blockwise_group_plain(items, block)
        return
    _check_quantize_group(items, block)
    if items[0][0].device.type != "cuda":
        raise ValueError(f"unsupported device {items[0][0].device}")
    table, held = [], []
    for x, q, scales in items:
        if x.numel() == 0:
            continue
        x = x.contiguous()
        held.append(x)                 # alive until the launches are queued
        table += _quantize_rows(x, q, scales, block)
    _launch_group(table, block, items[0][0].get_device(),
                  "quantize_blockwise")
