"""Scoring kernels of the batched Section 5.2 planner (float32).

* `prob_within(means, stds, e)` -- the accuracy probability
  ``P(1/(1+e) <= X <= 1+e)`` for X ~ N(mean, std^2), with the
  std <= 1e-12 indicator branch, elementwise.
* `fused_score(m, s, dm, vt, mq, mask67, pre9, extra, e, q)` -- one
  target record's whole candidate-scoring step: the sequential Goodman fold
  over the (candidate, child, fraction) stack, the deduction-error factors,
  the composed std, the masked probability, and the lines 6-9 winners per
  fraction (first argmax of p over `mask67 & (p >= q)`; where there is
  none, first argmin of `extra` over `pre9 & (p >= q)`; 2^31 - 1 when
  empty).

Each wrapper takes its route from the device of the tensors it is given:
on CUDA tensors it launches the hand-written kernels in
`csrc/planner_score.cu` (building them on first use) or raises; on CPU
tensors it runs the plain PyTorch version beside it.  `LAUNCHES` counts
kernel launches per wrapper.

Exactness contract, on either route: both functions evaluate the
probability through one expression (`prob_expr` here, `prob_expr.cuh` in
CUDA), so the p that `prob_within` recomputes from `fused_score`'s own
(cm, cs) has the same bits, and a (mean 1, std 0) pad along K is the exact
multiplicative identity of the fold.  Against the float64 NumPy scorer the
values are only float32-close (a different erf, float32 arithmetic).

The CUDA kernels replace the Pallas kernels `_prob_kernel` and
`_fused_kernel` of the JAX package.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import build

NO_WINNER = 2 ** 31 - 1
_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))
_SMALL_F32 = float(np.float32(1e-12))

LAUNCHES: Dict[str, int] = {"prob_within": 0, "fused_score": 0}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("planner_score")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.prob_within_launch.argtypes = [vp, vp, vp, ci, cf, cf, vp]
        lib.prob_within_launch.restype = ci
        lib.fused_score_launch.argtypes = [vp] * 10 + [ci, ci, ci,
                                                       cf, cf, cf, vp]
        lib.fused_score_launch.restype = ci
        lib.planner_error_string.argtypes = [ci]
        lib.planner_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch_check(err: int, what: str) -> None:
    if err != 0:
        msg = _load().planner_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (CUDA error {err})")


def bounds(e: float) -> Tuple[float, float]:
    """(lo, hi) = float32 roundings of the host's double 1/(1+e), 1+e."""
    return (float(np.float32(1.0 / (1.0 + e))), float(np.float32(1.0 + e)))


def _route(*ts: torch.Tensor) -> str:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
        if t.dtype != torch.float32:
            raise ValueError(f"expected float32 inputs, got {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def prob_expr(cm: torch.Tensor, cs: torch.Tensor, e: float) -> torch.Tensor:
    """The float32 probability expression both plain functions share.
    Divisors are full tensors, not Python scalars: on CUDA, PyTorch turns
    division by a scalar into multiplication by its reciprocal, which
    rounds differently."""
    lo, hi = bounds(e)
    small = cs <= _SMALL_F32
    s = torch.where(small, torch.ones_like(cs), cs)
    sqrt2 = torch.full_like(cs, _SQRT2_F32)
    phi_hi = 0.5 * (1.0 + torch.erf((hi - cm) / s / sqrt2))
    phi_lo = 0.5 * (1.0 + torch.erf((lo - cm) / s / sqrt2))
    ind = ((cm >= lo) & (cm <= hi)).to(torch.float32)
    return torch.where(small, ind, phi_hi - phi_lo)


def prob_within_plain(means: torch.Tensor, stds: torch.Tensor,
                      e: float) -> torch.Tensor:
    return prob_expr(means, stds, e)


def compose_plain(m: torch.Tensor, s: torch.Tensor, dm: torch.Tensor,
                  vt: torch.Tensor, mq: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential Goodman fold over K of (nc, K, nf) stacks, continued with
    the (nc,) deduction-error factors -> composed (mean, std), (nc, nf)."""
    e_prod = m[:, 0, :]
    v_term = s[:, 0, :] * s[:, 0, :] + e_prod * e_prod
    e2_term = e_prod * e_prod
    for kk in range(1, m.shape[1]):
        mk = m[:, kk, :]
        sk = s[:, kk, :]
        msq = mk * mk
        e_prod = e_prod * mk
        v_term = v_term * (sk * sk + msq)
        e2_term = e2_term * msq
    cm = e_prod * dm[:, None]
    v = v_term * vt[:, None]
    e2 = e2_term * mq[:, None]
    cs = torch.sqrt(torch.clamp_min(v - e2, 0.0))
    return cm, cs


def fused_score_plain(m, s, dm, vt, mq, mask67, pre9, extra, e: float,
                      q: float):
    cm, cs = compose_plain(m, s, dm, vt, mq)
    p = torch.where(mask67 | pre9, prob_expr(cm, cs, e),
                    torch.zeros_like(cm))
    sat = p >= float(np.float32(q))
    nc = p.shape[0]
    iota = torch.arange(nc, dtype=torch.int32, device=p.device)[:, None]
    big = torch.full_like(p, NO_WINNER, dtype=torch.int32)
    elig = mask67 & sat
    pe = torch.where(elig, p, torch.full_like(p, -1.0))
    best = pe.amax(dim=0, keepdim=True)
    w6 = torch.where(elig & (pe == best), iota, big).amin(dim=0)
    ok9 = pre9 & sat & ~elig.any(dim=0, keepdim=True)
    xe = torch.where(ok9, extra, torch.full_like(extra, math.inf))
    bx = xe.amin(dim=0, keepdim=True)
    w9 = torch.where(ok9 & (xe == bx), iota, big).amin(dim=0)
    return cm, cs, p, w6, w9


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def prob_within(means: torch.Tensor, stds: torch.Tensor,
                e: float) -> torch.Tensor:
    """Accuracy probability of each (mean, std), float32, any shape."""
    if means.shape != stds.shape:
        raise ValueError("means and stds must have one shape")
    if _route(means, stds) == "cpu":
        return prob_within_plain(means, stds, e)
    means = means.contiguous()
    stds = stds.contiguous()
    out = torch.empty_like(means)
    n = means.numel()
    if n == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError(f"{n} values exceed the kernel's int32 size")
    lo, hi = bounds(e)
    err = _load().prob_within_launch(
        means.data_ptr(), stds.data_ptr(), out.data_ptr(), n, lo, hi,
        torch.cuda.current_stream(means.device).cuda_stream)
    _launch_check(err, "prob_within")
    LAUNCHES["prob_within"] += 1
    return out


def fused_score(m: torch.Tensor, s: torch.Tensor, dm: torch.Tensor,
                vt: torch.Tensor, mq: torch.Tensor, mask67: torch.Tensor,
                pre9: Optional[torch.Tensor], extra: Optional[torch.Tensor],
                e: float, q: float):
    """One fused pass over a target's candidate stack.

    m, s: (nc, K, nf) child error-RV means / stds (K-padded with (1, 0));
    dm, vt, mq: (nc,) deduction-error factors (mean, std^2 + mean^2,
    mean^2); mask67, pre9: (nc, nf) bool eligibility of lines 6-7 / 8-9;
    extra: (nc, nf) summed sampling cost of unknown children.  None for
    pre9 / extra means all-False / zeros.  Returns (cm, cs, p) float32
    (nc, nf) and the winners (w6, w9) int32 (nf,).
    """
    nc, k, nf = m.shape
    if s.shape != m.shape or dm.shape != (nc,) or vt.shape != (nc,) \
            or mq.shape != (nc,) or mask67.shape != (nc, nf):
        raise ValueError("fused_score: inconsistent input shapes")
    if pre9 is None:
        pre9 = torch.zeros_like(mask67)
    if extra is None:
        extra = torch.zeros((nc, nf), dtype=torch.float32, device=m.device)
    if pre9.shape != (nc, nf) or extra.shape != (nc, nf):
        raise ValueError("fused_score: inconsistent input shapes")
    if mask67.dtype != torch.bool or pre9.dtype != torch.bool:
        raise ValueError("fused_score: masks must be bool tensors")
    if mask67.device != m.device or pre9.device != m.device:
        raise ValueError("all inputs must be on one device")
    if _route(m, s, dm, vt, mq, extra) == "cpu":
        return fused_score_plain(m, s, dm, vt, mq, mask67, pre9, extra, e, q)
    if k < 1 or nc * k * nf >= 2 ** 31:
        raise ValueError(f"stack {tuple(m.shape)} outside the kernel's sizes")
    ins = [t.contiguous() for t in (m, s, dm, vt, mq)]
    masks = [t.contiguous().view(torch.uint8) for t in (mask67, pre9)]
    extra = extra.contiguous()
    out = torch.empty((3, nc, nf), dtype=torch.float32, device=m.device)
    win = torch.empty((2, nf), dtype=torch.int32, device=m.device)
    if nc == 0 or nf == 0:
        win.fill_(NO_WINNER)
        return out[0], out[1], out[2], win[0], win[1]
    lo, hi = bounds(e)
    err = _load().fused_score_launch(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in masks),
        extra.data_ptr(), out.data_ptr(), win.data_ptr(), nc, k, nf, lo, hi,
        float(np.float32(q)),
        torch.cuda.current_stream(m.device).cuda_stream)
    _launch_check(err, "fused_score")
    LAUNCHES["fused_score"] += 1
    return out[0], out[1], out[2], win[0], win[1]
