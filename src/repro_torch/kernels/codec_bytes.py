"""NS and LDICT codec-size kernels: payload bytes per row of a column stack.

`ns_bytes` and `ldict_bytes` size an (m, n) int64 stack -- one row per
(target, column) SampleCF job, every row in its target's index order --
returning one int64 payload-byte count per row, exactly equal to the NumPy
batch formulas of `repro_torch.core.compression` (`ns_bytes_batch`,
`ldict_bytes_batch`).

Each wrapper takes its route from the device of the tensor it is given:
on a CUDA tensor it launches the hand-written kernel in `csrc/codec_bytes.cu`
(building it on first use) or raises; on a CPU tensor it runs the plain
PyTorch version beside it.  `LAUNCHES` counts kernel launches per wrapper.

The CUDA kernels replace the Pallas kernels `_ns_kernel` and
`_ldict_kernel` (with its per-page sort pre-pass) of the JAX package.  The
TPU path split values into uint32 planes and routed inputs outside an
int32 envelope to NumPy; these kernels read int64 directly and are exact
for every int64 input, so no routing remains.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build

PAGE_META = 16          # per-page metadata bytes of page-local methods
MAX_PAGE_P2 = 4096      # largest padded page the LDICT kernel sorts

LAUNCHES: Dict[str, int] = {"ns_bytes": 0, "ldict_bytes": 0}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("codec_bytes")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ns_bytes_launch.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.ns_bytes_launch.restype = ci
        lib.ldict_bytes_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.ldict_bytes_launch.restype = ci
        lib.codec_error_string.argtypes = [ci]
        lib.codec_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(cols: torch.Tensor, widths: torch.Tensor) -> None:
    if cols.dtype != torch.int64 or cols.dim() != 2:
        raise ValueError(f"cols must be a 2-D int64 tensor, got "
                         f"{cols.dtype} with shape {tuple(cols.shape)}")
    if widths.dtype != torch.int64 or widths.shape != (cols.shape[0],):
        raise ValueError("widths must be an int64 tensor of shape (m,)")
    if widths.device != cols.device:
        raise ValueError("cols and widths must be on the same device")
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cols.device}")


def _launch_check(err: int, what: str) -> None:
    if err != 0:
        msg = _load().codec_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (CUDA error {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU route, and the reference on the card)
# ---------------------------------------------------------------------------

def ns_bytes_plain(cols: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """NS bytes per row: sum of min(2 * min(sig(v), w) + 1, 2w) half-bytes,
    rounded up to bytes.  sig(v) counts the significant bytes of v read as
    uint64, so a negative value takes all 8."""
    m, n = cols.shape
    if n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    sig = torch.ones_like(cols)
    for k in range(1, 8):
        sig += (cols >= (1 << (8 * k))).to(torch.int64)
    sig = torch.where(cols < 0, 8, sig)
    w = widths[:, None]
    sig = torch.minimum(sig, w)
    half = torch.minimum(2 * sig + 1, 2 * w)
    return (half.sum(dim=1) + 1) // 2


def ldict_bytes_plain(cols: torch.Tensor, widths: torch.Tensor,
                      rpp: int) -> torch.Tensor:
    """LDICT bytes per row: rows cut into pages of `rpp` (the last page
    edge-padded with the row's last value), per page
    min(ndv * w + rows * ptr(ndv) + 16, rows * w + 16), summed."""
    m, n = cols.shape
    if n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    npages = -(-n // rpp)
    pad = npages * rpp - n
    if pad:
        cols = torch.cat([cols, cols[:, -1:].expand(m, pad)], dim=1)
    srt = cols.reshape(m, npages, rpp).sort(dim=2).values
    ndv = 1 + (srt[:, :, 1:] != srt[:, :, :-1]).sum(dim=2)
    rows = torch.full((npages,), rpp, dtype=torch.int64, device=cols.device)
    rows[-1] = n - (npages - 1) * rpp
    w = widths[:, None]
    ptr = torch.where(ndv <= 256, 1, torch.where(ndv <= 65536, 2, 3))
    per_page = ndv * w + rows * ptr + PAGE_META
    return torch.minimum(per_page, rows * w + PAGE_META).sum(dim=1)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def ns_bytes(cols: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """NS payload bytes per row of an (m, n) int64 stack -> (m,) int64."""
    _check_inputs(cols, widths)
    if cols.device.type == "cpu":
        return ns_bytes_plain(cols, widths)
    m, n = cols.shape
    if m == 0 or n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    if m >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"stack {tuple(cols.shape)} exceeds the kernel's "
                         "int32 sizes")
    cols = cols.contiguous()
    widths = widths.contiguous()
    out = torch.empty(m, dtype=torch.int64, device=cols.device)
    err = _load().ns_bytes_launch(cols.data_ptr(), widths.data_ptr(),
                                  out.data_ptr(), m, n, _stream(cols))
    _launch_check(err, "ns_bytes")
    LAUNCHES["ns_bytes"] += 1
    return out


def ldict_bytes(cols: torch.Tensor, widths: torch.Tensor,
                rpp: int) -> torch.Tensor:
    """LDICT payload bytes per row of an (m, n) int64 stack at `rpp`
    rows per page -> (m,) int64."""
    _check_inputs(cols, widths)
    rpp = int(rpp)
    if rpp < 1:
        raise ValueError(f"rows per page must be >= 1, got {rpp}")
    if cols.device.type == "cpu":
        return ldict_bytes_plain(cols, widths, rpp)
    m, n = cols.shape
    if m == 0 or n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    npages = -(-n // rpp)
    p2 = 1 << (min(rpp, n) - 1).bit_length()
    if p2 > MAX_PAGE_P2:
        raise ValueError(f"a page of {min(rpp, n)} rows exceeds the "
                         f"kernel's {MAX_PAGE_P2}-row shared-memory page")
    if m * npages >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"stack {tuple(cols.shape)} at rpp {rpp} exceeds "
                         "the kernel's grid")
    cols = cols.contiguous()
    widths = widths.contiguous()
    out = torch.zeros(m, dtype=torch.int64, device=cols.device)
    err = _load().ldict_bytes_launch(cols.data_ptr(), widths.data_ptr(),
                                     out.data_ptr(), m, n, rpp, p2,
                                     _stream(cols))
    _launch_check(err, "ldict_bytes")
    LAUNCHES["ldict_bytes"] += 1
    return out
