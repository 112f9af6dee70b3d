"""Stochastic error model for size estimation (paper §5.1 + Appendix C).

Every estimator's result, divided by the true size, is a random variable X
(X=1 is perfect).  We track (E[X], Std[X]) per estimate:

* SampleCF errors follow the c*ln(f) fits of Table 2.
* Deduction errors follow the linear-in-a fits of Table 3 (a = number of
  indexes extrapolated from).
* Deduced estimates compose as products of RVs; the variance of a product of
  independent RVs is Goodman's formula [9]:
      V(prod X_i) = prod(V_i + E_i^2) - prod(E_i^2).
* The accuracy constraint holds if P(1/(1+e) <= X <= 1+e) >= q under a
  normal approximation (App. C observed near-normal error distributions).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable, Tuple

import numpy as np

from .compression import METHODS


@dataclasses.dataclass(frozen=True)
class ErrorRV:
    mean: float  # E[X]
    std: float   # Std[X]

    @property
    def var(self) -> float:
        return self.std * self.std


EXACT = ErrorRV(1.0, 0.0)

# Appendix-C style fits (bias/stddev = c * (-ln f)); NS bias is ~0
# ("unbiased", [11]).  The ORD-IND constants match the paper's Table 2.
# The ORD-DEP constants are RE-FIT on our substrate (benchmarks/fig9): our
# tables are ~100x smaller than TPC-H SF1, so a sample of fraction f shrinks
# value run lengths below 1 and local-dictionary sizes are overestimated much
# more than in the paper (bias ~0.08*(-ln f) raw).  The framework only needs
# errors to be *characterizable* (App. C last paragraph), so we carry our own
# constants — and additionally BIAS-CORRECT the ORD-DEP estimate by the
# fitted E[X] (a beyond-paper extension).
_SAMPLECF_FITS = {
    "ORD-IND": {"bias": 0.0, "std": 0.0062},
    "ORD-DEP": {"bias": 0.08, "std": 0.055},
}

# Table 3 fits for deductions. a = number of extrapolated indexes.
_COLSET = ErrorRV(1.0, 0.0003)
_COLEXT = {
    "ORD-IND": {"bias": +0.01, "std": 0.002},
    "ORD-DEP": {"bias": -0.03, "std": 0.01},
}


@functools.lru_cache(maxsize=None)
def samplecf_bias(method: str, f: float) -> float:
    """Fitted E[X] of a raw SampleCF estimate (used for bias correction)."""
    fit = _SAMPLECF_FITS[METHODS[method].kind]
    lf = -math.log(max(min(f, 1.0), 1e-9))
    return 1.0 + fit["bias"] * lf


@functools.lru_cache(maxsize=None)
def samplecf_error(method: str, f: float) -> ErrorRV:
    """Error RV of the bias-corrected SampleCF: the estimate is divided by
    the fitted E[X], leaving mean 1 and a shrunk std."""
    kind = METHODS[method].kind
    fit = _SAMPLECF_FITS[kind]
    lf = -math.log(max(min(f, 1.0), 1e-9))  # -ln f  >= 0
    mean = 1.0 + fit["bias"] * lf
    std = fit["std"] * lf
    return ErrorRV(1.0, std / mean)


def colset_error() -> ErrorRV:
    return _COLSET


@functools.lru_cache(maxsize=None)
def colext_error(method: str, a: int) -> ErrorRV:
    kind = METHODS[method].kind
    fit = _COLEXT[kind]
    return ErrorRV(1.0 + fit["bias"] * a, fit["std"] * a)


def compose(rvs: Iterable[ErrorRV]) -> ErrorRV:
    """Product of independent RVs: E = prod E_i; V per Goodman [9]."""
    e_prod = 1.0
    v_term = 1.0
    e2_term = 1.0
    for rv in rvs:
        e_prod *= rv.mean
        v_term *= rv.var + rv.mean * rv.mean
        e2_term *= rv.mean * rv.mean
    var = max(v_term - e2_term, 0.0)
    return ErrorRV(e_prod, math.sqrt(var))


def goodman_fold(means: np.ndarray, stds: np.ndarray, axis: int = -1
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The raw Goodman accumulators (E-product, V-term, E^2-term) along
    `axis`: E = prod E_i, V = prod(V_i + E_i^2) - prod(E_i^2) [9].
    `np.multiply.reduce` is a strict sequential left-fold (numpy pairwise
    blocking applies to additive reductions only), so the float ops run in
    factor order.  A factor of (1, 0) is the exact multiplicative
    identity, which is what makes EXACT-padding ragged candidate stacks
    safe — and the fold can be *continued* with further factors (the
    planner engine appends the deduction-error term this way).
    """
    means = np.asarray(means, dtype=np.float64)
    stds = np.asarray(stds, dtype=np.float64)
    msq = means * means
    e_prod = np.multiply.reduce(means, axis=axis)
    v_term = np.multiply.reduce(stds * stds + msq, axis=axis)
    e2_term = np.multiply.reduce(msq, axis=axis)
    return e_prod, v_term, e2_term


def compose_batch(means: np.ndarray, stds: np.ndarray, axis: int = -1
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """`compose` over stacks: Goodman's formula along `axis`, bit-identical
    to folding the scalar `compose` over the factors in axis order."""
    e_prod, v_term, e2_term = goodman_fold(means, stds, axis)
    var = np.maximum(v_term - e2_term, 0.0)
    return e_prod, np.sqrt(var)


_SQRT2 = math.sqrt(2.0)
# np.frompyfunc(math.erf) rather than scipy's erf: the numpy backend's
# planner decisions must be bit-identical to the JAX package's numpy
# backend, and only calling the SAME libm erf guarantees that.
_ERF_VEC = np.frompyfunc(math.erf, 1, 1)


def _erf_exact(x: np.ndarray) -> np.ndarray:
    return _ERF_VEC(x).astype(np.float64)


def prob_within_batch(means: np.ndarray, stds: np.ndarray,
                      e: float) -> np.ndarray:
    """P(1/(1+e) <= X <= 1+e) under X ~ N(mean, std^2), over (mean, std)
    stacks of any shape, in float64 with the exact libm erf (the numpy
    backend's scorer); std <= 1e-12 is the deterministic indicator.  The
    torch backend scores with the float32 kernels of
    `repro_torch.kernels.planner_score` instead.
    """
    means = np.asarray(means, dtype=np.float64)
    stds = np.asarray(stds, dtype=np.float64)
    lo, hi = 1.0 / (1.0 + e), 1.0 + e
    out = np.where((lo <= means) & (means <= hi), 1.0, 0.0)
    big = stds > 1e-12
    if np.any(big):
        m = means[big]
        s = stds[big]
        phi_hi = 0.5 * (1.0 + _erf_exact((hi - m) / s / _SQRT2))
        phi_lo = 0.5 * (1.0 + _erf_exact((lo - m) / s / _SQRT2))
        out[big] = phi_hi - phi_lo
    return out




def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


@functools.lru_cache(maxsize=65536)
def prob_within(rv: ErrorRV, e: float) -> float:
    """P(1/(1+e) <= X <= 1+e) under N(mean, std^2): the scalar form of
    `prob_within_batch`, used by the exponential Optimal recursion."""
    lo, hi = 1.0 / (1.0 + e), 1.0 + e
    if rv.std <= 1e-12:
        return 1.0 if lo <= rv.mean <= hi else 0.0
    return _phi((hi - rv.mean) / rv.std) - _phi((lo - rv.mean) / rv.std)


def satisfies(rv: ErrorRV, e: float, q: float) -> bool:
    return prob_within(rv, e) >= q
