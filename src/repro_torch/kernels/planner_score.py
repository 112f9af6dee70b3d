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
* `planner_walk(g, e, q, q_feas)` -- the whole greedy of one plan (lines
  6-11 of the Section 5.2 pseudocode over every target record in order,
  for every sampling fraction) on one packed graph `WalkGraph`: the final
  node states, float64 error-RV means and stds, the winner of each
  (record, fraction) and the float64 sampling cost per fraction, then the
  plan's feasibility per fraction: each target's accuracy probability p
  from its final RV rounded to float32, and whether every float64(p) >=
  q_feas (`WalkResult`).
  Its plain version walks the records one by one and scores each with
  `fused_score`, and the targets with `prob_within` (on CUDA tensors, the
  two kernels), so on the card it is the walk kernel's bitwise reference.
  Where the greedy works in
  float64 the walk does too: p >= q compares float64(p) with q, the
  unknown children's cost is a float64 sum in child order, the lines 8-9
  winner is the first argmin of that sum, `total` adds float64 costs in
  record order, and SAMPLED nodes hold the float64 SampleCF RV.
  `walk_in_shared_memory(g)` says which of the kernel's two layouts a
  graph takes: the node state in shared memory, or (beyond ~9,000 nodes
  on an H100) in global memory.

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
`_fused_kernel` of the JAX package; the walk replaces `_fused_kernel`
together with the per-record host loop around it (`core/planner_engine.py`
`_run`) and the per-plan `_prob_kernel` call of its feasibility check;
`prob_within` stays for single records.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build

NO_WINNER = 2 ** 31 - 1
# node state codes of the walk (the planner engine's)
NONE, DEDUCED, SAMPLED, EXACT = 0, 1, 2, 3
# walk winner codes per (record, fraction): a candidate index (lines 6-7),
# WALK_LINE9 + index (lines 8-9), or one of these two
WALK_SKIP = -1          # the target was resolved by an earlier record
WALK_FALLBACK = -2      # lines 10-11: SampleCF on the target
WALK_LINE9 = 1 << 20
_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))
_SMALL_F32 = float(np.float32(1e-12))

LAUNCHES: Dict[str, int] = {"prob_within": 0, "fused_score": 0,
                             "planner_walk": 0}

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
        lib.planner_walk_launch.argtypes = [vp] * 20 + [ci] * 7 + [
            cf, cf, ctypes.c_double, ctypes.c_double, vp]
        lib.planner_walk_launch.restype = ci
        lib.planner_walk_in_smem.argtypes = [ci, ci]
        lib.planner_walk_in_smem.restype = ci
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


@dataclasses.dataclass
class WalkGraph:
    """One plan's deduction graph, packed for `planner_walk`.

    R records in processing order (a target that occurs twice has two
    records), C candidates in all, n nodes plus the EXACT pad node n:
    tid, kind (R,) int32 -- target node, order class (row of samp_*);
    cand_off (R + 1,) int32 -- record r's candidates are
    cand_off[r] .. cand_off[r + 1] - 1;
    child (C, K) int32 -- child node ids in child order, padded with n;
    nchild (C,) int32 -- real children (>= 1);
    dm, vt, mq (C,) float32 -- deduction-error factors (mean, std^2 +
    mean^2, mean^2);
    scost (n + 1, nf) float64 -- sampling costs, 0 on the pad row;
    samp_mean, samp_std (2, nf) float64 -- SampleCF error RV per order
    class and fraction;
    targets (T,) int32 -- the plan's target nodes, whose final RVs judge
    its feasibility;
    max_cands -- the most candidates of a record;
    exact (X,) int32 -- nodes that start EXACT with RV (1, 0): existing
    indexes (§5.1), known at no cost; None for none.
    """
    tid: torch.Tensor
    kind: torch.Tensor
    cand_off: torch.Tensor
    child: torch.Tensor
    nchild: torch.Tensor
    dm: torch.Tensor
    vt: torch.Tensor
    mq: torch.Tensor
    scost: torch.Tensor
    samp_mean: torch.Tensor
    samp_std: torch.Tensor
    targets: torch.Tensor
    max_cands: int
    exact: Optional[torch.Tensor] = None


class WalkResult(NamedTuple):
    state: torch.Tensor   # (n + 1, nf) uint8 state codes
    mean: torch.Tensor    # (n + 1, nf) float64 error-RV means
    std: torch.Tensor     # (n + 1, nf) float64 error-RV stds
    win: torch.Tensor     # (R, nf) int32 winner codes
    total: torch.Tensor   # (nf,) float64 sampling cost
    p: torch.Tensor       # (T, nf) float32 accuracy probability per target
    feasible: torch.Tensor  # (nf,) bool: every target's p >= q_feas


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


def _first_index(hit: torch.Tensor) -> torch.Tensor:
    """(nc, nf) bool -> (nf,) first row that is True (nc where none)."""
    nc = hit.shape[0]
    iota = torch.arange(nc, device=hit.device)[:, None]
    return torch.where(hit, iota, nc).amin(dim=0)


def planner_walk_plain(g: WalkGraph, e: float, q: float,
                       q_feas: Optional[float] = None) -> WalkResult:
    """The greedy record by record, vectorised over the fractions; each
    record scored by `fused_score` (its winners are taken here, in
    float64, as the walk takes them), the targets' final RVs by
    `prob_within`."""
    dev = g.scost.device
    n1, nf = g.scost.shape
    k = g.child.shape[1]
    state = torch.zeros((n1, nf), dtype=torch.uint8, device=dev)
    state[n1 - 1] = EXACT
    if g.exact is not None:
        state[g.exact.long()] = EXACT
    mean = torch.ones((n1, nf), dtype=torch.float64, device=dev)
    std = torch.zeros((n1, nf), dtype=torch.float64, device=dev)
    total = torch.zeros(nf, dtype=torch.float64, device=dev)
    nrec = g.tid.numel()
    win = torch.empty((nrec, nf), dtype=torch.int32, device=dev)
    fi = torch.arange(nf, device=dev)
    none_f = torch.zeros(nf, dtype=torch.bool, device=dev)
    child = g.child.long()
    tids, kinds, offs = g.tid.tolist(), g.kind.tolist(), g.cand_off.tolist()
    for r in range(nrec):
        t, o, o2 = tids[r], offs[r], offs[r + 1]
        smean, sstd = g.samp_mean[kinds[r]], g.samp_std[kinds[r]]
        act = state[t] == NONE
        if not bool(act.any()):               # resolved by an earlier record
            win[r] = WALK_SKIP
            continue
        has6 = has9 = none_f
        code = fi
        if o2 > o:
            ch = child[o:o2]                               # (nc, K)
            known = state[ch] != NONE                      # (nc, K, nf)
            allk = known.all(dim=1)
            # unknown children hypothetically sampled
            m = torch.where(known, mean[ch], smean).to(torch.float32)
            s = torch.where(known, std[ch], sstd).to(torch.float32)
            cost = torch.where(known, 0.0, g.scost[ch])
            extra = cost[:, 0]
            for j in range(1, k):                          # child order
                extra = extra + cost[:, j]
            mask67 = allk & act
            pre9 = ~allk & (extra < g.scost[t]) & act
            cm, cs, p, _, _ = fused_score(m, s, g.dm[o:o2], g.vt[o:o2],
                                          g.mq[o:o2], mask67, pre9,
                                          extra.to(torch.float32), e, q)
            sat = p.to(torch.float64) >= q
            elig = mask67 & sat
            has6 = elig.any(dim=0)
            pe = torch.where(elig, p, -1.0)
            w6 = _first_index(elig & (pe == pe.amax(dim=0)))
            ok9 = pre9 & sat & ~has6
            has9 = ok9.any(dim=0)
            xe = torch.where(ok9, extra, math.inf)
            w9 = _first_index(ok9 & (xe == xe.amin(dim=0)))
            w = torch.where(has6, w6, torch.where(has9, w9, 0))
            # lines 8-9: the winner's unresolved children are sampled
            ids = ch[w]                                    # (nf, K)
            nch = g.nchild[o + w]
            for j in range(k):
                idj = ids[:, j]
                cur = state[idj, fi]
                new = has9 & (j < nch) & (cur == NONE)
                state[idj, fi] = torch.where(new, SAMPLED, cur)
                mean[idj, fi] = torch.where(new, smean, mean[idj, fi])
                std[idj, fi] = torch.where(new, sstd, std[idj, fi])
                total = total + torch.where(new, g.scost[idj, fi], 0.0)
            ded = has6 | has9
            state[t] = torch.where(ded, DEDUCED, state[t])
            mean[t] = torch.where(ded, cm[w, fi].to(torch.float64), mean[t])
            std[t] = torch.where(ded, cs[w, fi].to(torch.float64), std[t])
            code = torch.where(has6, w6, w9 + WALK_LINE9)
        # lines 10-11
        rest = act & ~has6 & ~has9
        state[t] = torch.where(rest, SAMPLED, state[t])
        mean[t] = torch.where(rest, smean, mean[t])
        std[t] = torch.where(rest, sstd, std[t])
        total = total + torch.where(rest, g.scost[t], 0.0)
        win[r] = torch.where(~act, WALK_SKIP,
                             torch.where(has6 | has9, code, WALK_FALLBACK))
    tg = g.targets.long()
    p = prob_within(mean[tg].to(torch.float32), std[tg].to(torch.float32), e)
    q_feas = q if q_feas is None else q_feas
    return WalkResult(state, mean, std, win, total, p,
                      (p.to(torch.float64) >= q_feas).all(dim=0))


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


def walk_in_shared_memory(g: WalkGraph) -> bool:
    """Whether `planner_walk` keeps the node state of the CUDA graph `g` in
    shared memory (where it fits in what a block may opt into, ~9,000
    nodes on an H100), else in global memory."""
    if not g.scost.is_cuda:
        raise ValueError("walk_in_shared_memory takes a graph on the card")
    r = _load().planner_walk_in_smem(g.scost.shape[0], max(g.max_cands, 1))
    if r < 0:
        _launch_check(-r, "planner_walk_in_smem")
    return r == 1


def planner_walk(g: WalkGraph, e: float, q: float,
                 q_feas: Optional[float] = None) -> WalkResult:
    """The greedy of one plan over the packed graph `g` (see `WalkGraph`,
    `WalkResult`) under accuracy (e, q), its feasibility judged against
    q_feas (q by default); one launch for every fraction on a CUDA
    graph."""
    n1, nf = g.scost.shape
    nrec = g.tid.numel()
    nt = g.targets.numel()
    nc = g.dm.numel()
    k = g.child.shape[1]
    exact = g.exact if g.exact is not None else torch.empty(
        0, dtype=torch.int32, device=g.scost.device)
    ints = (g.tid, g.kind, g.cand_off, g.child, g.nchild, g.targets, exact)
    floats = (g.dm, g.vt, g.mq)
    doubles = (g.scost, g.samp_mean, g.samp_std)
    if any(t.dtype != torch.int32 for t in ints) or \
            any(t.dtype != torch.float32 for t in floats) or \
            any(t.dtype != torch.float64 for t in doubles):
        raise ValueError("planner_walk: index arrays must be int32, factors "
                         "float32, costs and SampleCF RVs float64")
    if g.kind.shape != (nrec,) or g.cand_off.shape != (nrec + 1,) or \
            g.child.shape[0] != nc or g.nchild.shape != (nc,) or \
            g.vt.shape != (nc,) or g.mq.shape != (nc,) or k < 1 or \
            g.samp_mean.shape != (2, nf) or g.samp_std.shape != (2, nf) \
            or g.targets.shape != (nt,) or exact.dim() != 1:
        raise ValueError("planner_walk: inconsistent packed graph")
    if exact.numel() and not bool(((exact >= 0) & (exact < n1)).all()):
        raise ValueError("planner_walk: an exact id outside the graph's "
                         "nodes")
    dev = g.scost.device
    if any(t.device != dev for t in ints + floats + doubles):
        raise ValueError("all inputs must be on one device")
    q_feas = q if q_feas is None else q_feas
    if dev.type == "cpu":
        return planner_walk_plain(g, e, q, q_feas)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if g.max_cands >= WALK_LINE9 or nc * k >= 2 ** 31 or \
            n1 * nf >= 2 ** 31 or nt * nf >= 2 ** 31 or \
            exact.numel() >= 2 ** 31:
        raise ValueError("planner_walk: graph outside the kernel's sizes")
    ins = [t.contiguous() for t in ints + floats]
    scost_t = g.scost.t().contiguous()
    samp = [t.contiguous() for t in doubles[1:]]
    state = torch.empty((nf, n1), dtype=torch.uint8, device=dev)
    mean = torch.empty((nf, n1), dtype=torch.float64, device=dev)
    std = torch.empty((nf, n1), dtype=torch.float64, device=dev)
    win = torch.empty((nrec, nf), dtype=torch.int32, device=dev)
    total = torch.empty(nf, dtype=torch.float64, device=dev)
    p = torch.empty((nt, nf), dtype=torch.float32, device=dev)
    feasible = torch.empty(nf, dtype=torch.uint8, device=dev)
    res = WalkResult(state.t(), mean.t(), std.t(), win, total, p,
                     feasible.view(torch.bool))
    if nf == 0:
        return res
    lo, hi = bounds(e)
    err = _load().planner_walk_launch(
        *(t.data_ptr() for t in ins), scost_t.data_ptr(),
        *(t.data_ptr() for t in samp),
        *(t.data_ptr() for t in (state, mean, std, win, total, p, feasible)),
        nrec, k, n1, nf, max(g.max_cands, 1), nt, exact.numel(), lo, hi,
        float(q),
        float(q_feas), torch.cuda.current_stream(dev).cuda_stream)
    _launch_check(err, "planner_walk")
    LAUNCHES["planner_walk"] += 1
    return res
