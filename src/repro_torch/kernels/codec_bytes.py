"""Codec-size kernels: payload bytes per row of a column stack, for the
five compression methods of the paper's Section 2.1.

`ns_bytes`, `gdict_bytes`, `ldict_bytes`, `prefix_bytes` and `rle_bytes`
size an (m, n) int64 stack -- one row per (target, column) SampleCF job,
every row in its target's index order -- returning one int64 payload-byte
count per row, exactly equal to the NumPy batch formulas of
`repro_torch.core.compression` (`<method>_bytes_batch`).

Each wrapper takes its route from the device of the tensor it is given:
on a CUDA tensor it launches the hand-written kernel in `csrc/codec_bytes.cu`
(building it on first use) or raises; on a CPU tensor it runs the plain
PyTorch version beside it.  `LAUNCHES` counts kernel launches per wrapper.

The CUDA kernels replace the Pallas kernels `_ns_kernel`, `_gdict_kernel`,
`_ldict_kernel` (with its per-page sort pre-pass), `_prefix_kernel` and
`_rle_kernel` of the JAX package.  The TPU path split values into uint32
planes and routed inputs outside an int32 envelope (negatives among them)
to NumPy; these kernels read int64 directly and are exact for every int64
input, so no routing remains.  GDICT and LDICT count distinct values with
a hash set on the card, not a sort (`gdict_plan` says how GDICT's table of
a row is laid out).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from . import build

PAGE_META = 16          # per-page metadata bytes of page-local methods
MAX_PAGE_P2 = 4096      # largest page (rounded up to a power of two) the
                        # LDICT kernel's shared-memory hash set takes
# GDICT's hash set of a row: 2^log_slots >= 7n / 4 slots (never more than
# 4/7 full), 64 at least, in one block's shared memory up to BLOCK_SLOTS
# (64 KB), split over a cluster of up to MAX_CLUSTER blocks of at most
# SHARE_SLOTS (128 KB) each up to MAX_CLUSTER * SHARE_SLOTS, in global
# memory beyond, one table per cluster of MAX_CLUSTER blocks, as many at
# once as fit in L2_TABLE_BYTES of the card's 50 MB L2 (one at least, a
# cluster for every MAX_CLUSTER SMs at most)
GDICT_BLOCK_SLOTS = 1 << 13
GDICT_SHARE_SLOTS = 1 << 14
GDICT_MAX_CLUSTER = 8
GDICT_L2_TABLE_BYTES = 32 << 20
GDICT_ROUTES = ("block", "cluster", "global")

LAUNCHES: Dict[str, int] = {"ns_bytes": 0, "gdict_bytes": 0,
                            "ldict_bytes": 0, "prefix_bytes": 0,
                            "rle_bytes": 0}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("codec_bytes")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ns_bytes_launch.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.ns_bytes_launch.restype = ci
        lib.gdict_bytes_launch.argtypes = [vp, vp, vp] + [ci] * 5 + [
            vp, ci, vp]
        lib.gdict_bytes_launch.restype = ci
        for fn in (lib.ldict_bytes_launch, lib.prefix_bytes_launch,
                   lib.rle_bytes_launch):
            fn.argtypes = [vp, vp, vp, ci, ci, ci, vp]
            fn.restype = ci
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


def _check_rpp(rpp) -> int:
    rpp = int(rpp)
    if rpp < 1:
        raise ValueError(f"rows per page must be >= 1, got {rpp}")
    return rpp


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU route, and the reference on the card)
# ---------------------------------------------------------------------------

def _sig_bytes(v: torch.Tensor) -> torch.Tensor:
    """Significant bytes of each int64 read as uint64 (a negative value
    takes all 8)."""
    sig = torch.ones_like(v)
    for k in range(1, 8):
        sig += (v >= (1 << (8 * k))).to(torch.int64)
    return torch.where(v < 0, 8, sig)


def _ptr_bytes(ndv: torch.Tensor) -> torch.Tensor:
    return torch.where(ndv <= 256, 1, torch.where(ndv <= 65536, 2, 3))


def _pages(cols: torch.Tensor, rpp: int):
    """(m, n) -> ((m, npages, rpp) edge-padded with each row's last value,
    (npages,) rows actually stored in each page)."""
    m, n = cols.shape
    npages = -(-n // rpp)
    pad = npages * rpp - n
    if pad:
        cols = torch.cat([cols, cols[:, -1:].expand(m, pad)], dim=1)
    rows = torch.full((npages,), rpp, dtype=torch.int64, device=cols.device)
    rows[-1] = n - (npages - 1) * rpp
    return cols.reshape(m, npages, rpp), rows


def ns_bytes_plain(cols: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """NS bytes per row: sum of min(2 * min(sig(v), w) + 1, 2w) half-bytes,
    rounded up to bytes.  sig(v) counts the significant bytes of v read as
    uint64, so a negative value takes all 8."""
    m, n = cols.shape
    if n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    sig = _sig_bytes(cols)
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
    pages, rows = _pages(cols, rpp)
    srt = pages.sort(dim=2).values
    ndv = 1 + (srt[:, :, 1:] != srt[:, :, :-1]).sum(dim=2)
    w = widths[:, None]
    per_page = ndv * w + rows * _ptr_bytes(ndv) + PAGE_META
    return torch.minimum(per_page, rows * w + PAGE_META).sum(dim=1)


def gdict_bytes_plain(cols: torch.Tensor,
                      widths: torch.Tensor) -> torch.Tensor:
    """GDICT bytes per row: ndv distinct values of the row,
    ndv * w + n * ptr(ndv)."""
    m, n = cols.shape
    if n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    srt = cols.sort(dim=1).values
    ndv = 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1)
    return ndv * widths + n * _ptr_bytes(ndv)


def prefix_bytes_plain(cols: torch.Tensor, widths: torch.Tensor,
                       rpp: int) -> torch.Tensor:
    """PREFIX bytes per row: per page, the signed min and max XORed as
    uint64 give the differing bytes diff (0 when equal), common =
    max(w - diff, 0), and the page takes
    min(common + rows * (1 + w - common) + 16, rows * w + 16); summed."""
    m, n = cols.shape
    if n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    pages, rows = _pages(cols, rpp)
    xor = pages.amin(dim=2) ^ pages.amax(dim=2)
    diff = torch.where(xor == 0, 0, _sig_bytes(xor))
    w = widths[:, None]
    common = torch.clamp(w - diff, min=0)
    per_page = common + rows * (1 + w - common) + PAGE_META
    return torch.minimum(per_page, rows * w + PAGE_META).sum(dim=1)


def rle_bytes_plain(cols: torch.Tensor, widths: torch.Tensor,
                    rpp: int) -> torch.Tensor:
    """RLE bytes per row: per page (in the order given), runs = 1 +
    #(adjacent unequal), min(runs * (w + 2) + 16, rows * w + 16); summed."""
    m, n = cols.shape
    if n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    pages, rows = _pages(cols, rpp)
    runs = 1 + (pages[:, :, 1:] != pages[:, :, :-1]).sum(dim=2)
    w = widths[:, None]
    per_page = runs * (w + 2) + PAGE_META
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
    rpp = _check_rpp(rpp)
    if cols.device.type == "cpu":
        return ldict_bytes_plain(cols, widths, rpp)
    m, n = cols.shape
    if m == 0 or n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    if 1 << (min(rpp, n) - 1).bit_length() > MAX_PAGE_P2:
        raise ValueError(f"a page of {min(rpp, n)} rows exceeds the "
                         f"kernel's {MAX_PAGE_P2}-row shared-memory page")
    return _paged_launch("ldict_bytes", cols, widths, rpp)


class GdictPlan(NamedTuple):
    """How the GDICT kernel lays out the hash set of each row: `route`
    "block" (the table in a block's shared memory), "cluster" (split over
    the shared memory of `parts` blocks of a thread-block cluster; 1: one
    block in a plain launch) or "global" (`tables` tables in global
    memory at once, the scratch of `scratch_bytes`, each filled by a
    cluster of `parts` blocks), with 2^log_slots slots a row."""
    route: str
    log_slots: int
    parts: int
    tables: int

    @property
    def scratch_bytes(self) -> int:
        return self.tables << (self.log_slots + 3)


def gdict_plan(m: int, n: int, sms: int) -> GdictPlan:
    """The GDICT kernel's layout for an (m, n) stack on a card of `sms`
    SMs (n >= 1).  A cluster doubles from the fewest blocks that hold the
    table while the rows alone would leave SMs idle, as NS's does."""
    log_slots = max(6, (-(-7 * n // 4) - 1).bit_length())
    slots = 1 << log_slots
    if slots <= GDICT_BLOCK_SLOTS:
        return GdictPlan("block", log_slots, 1, 0)
    if slots <= GDICT_MAX_CLUSTER * GDICT_SHARE_SLOTS:
        parts = max(1, slots // GDICT_SHARE_SLOTS)
        while parts < GDICT_MAX_CLUSTER and m * parts < sms:
            parts *= 2
        return GdictPlan("cluster", log_slots, parts, 0)
    fit = max(1, GDICT_L2_TABLE_BYTES // (slots * 8))
    return GdictPlan("global", log_slots, GDICT_MAX_CLUSTER,
                     min(m, max(1, sms // GDICT_MAX_CLUSTER), fit))


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gdict_bytes(cols: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """GDICT payload bytes per row of an (m, n) int64 stack -> (m,) int64.
    On the card one launch counts each row's distinct values with a hash
    set (`gdict_plan`), no sort; the global-memory tables of the longest
    rows are scratch allocated here."""
    _check_inputs(cols, widths)
    if cols.device.type == "cpu":
        return gdict_bytes_plain(cols, widths)
    m, n = cols.shape
    if m == 0 or n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    if m >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"stack {tuple(cols.shape)} exceeds the kernel's "
                         "int32 sizes")
    plan = gdict_plan(m, n, _sm_count(cols.device))
    if plan.log_slots > 31 or m * plan.parts >= 2 ** 31:
        raise ValueError(f"stack {tuple(cols.shape)} exceeds the kernel's "
                         "2^31-slot hash set or grid")
    cols = cols.contiguous()
    widths = widths.contiguous()
    out = torch.empty(m, dtype=torch.int64, device=cols.device)
    scratch = torch.empty(plan.scratch_bytes // 8, dtype=torch.int64,
                          device=cols.device) if plan.tables else None
    err = _load().gdict_bytes_launch(
        cols.data_ptr(), widths.data_ptr(), out.data_ptr(), m, n,
        GDICT_ROUTES.index(plan.route), plan.log_slots, plan.parts,
        None if scratch is None else scratch.data_ptr(), plan.tables,
        _stream(cols))
    _launch_check(err, "gdict_bytes")
    LAUNCHES["gdict_bytes"] += 1
    return out


def _paged_launch(name: str, cols: torch.Tensor, widths: torch.Tensor,
                  rpp: int) -> torch.Tensor:
    """Launch the paged kernel `name` (LDICT, PREFIX or RLE) on a CUDA
    stack."""
    m, n = cols.shape
    if m == 0 or n == 0:
        return torch.zeros(m, dtype=torch.int64, device=cols.device)
    if m * -(-n // rpp) >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"stack {tuple(cols.shape)} at rpp {rpp} exceeds "
                         "the kernel's grid")
    cols = cols.contiguous()
    widths = widths.contiguous()
    out = torch.zeros(m, dtype=torch.int64, device=cols.device)
    err = getattr(_load(), f"{name}_launch")(
        cols.data_ptr(), widths.data_ptr(), out.data_ptr(), m, n, rpp,
        _stream(cols))
    _launch_check(err, name)
    LAUNCHES[name] += 1
    return out


def prefix_bytes(cols: torch.Tensor, widths: torch.Tensor,
                 rpp: int) -> torch.Tensor:
    """PREFIX payload bytes per row of an (m, n) int64 stack at `rpp`
    rows per page -> (m,) int64."""
    _check_inputs(cols, widths)
    rpp = _check_rpp(rpp)
    if cols.device.type == "cpu":
        return prefix_bytes_plain(cols, widths, rpp)
    return _paged_launch("prefix_bytes", cols, widths, rpp)


def rle_bytes(cols: torch.Tensor, widths: torch.Tensor,
              rpp: int) -> torch.Tensor:
    """RLE payload bytes per row of an (m, n) int64 stack at `rpp` rows
    per page -> (m,) int64."""
    _check_inputs(cols, widths)
    rpp = _check_rpp(rpp)
    if cols.device.type == "cpu":
        return rle_bytes_plain(cols, widths, rpp)
    return _paged_launch("rle_bytes", cols, widths, rpp)
