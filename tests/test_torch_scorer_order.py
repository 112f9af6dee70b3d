"""The order of the port's float32 weighted totals.

The torch backend's greedy-step scorers (`_score_secondary_torch`,
`_score_replace_torch`) sum `q_w @ new_q` over the query axis in the
order XLA's CPU code sums the JAX package's fused scorers
(`cost_engine._xla_sum_order`): a chain of float32 fused multiply-adds
in query order where XLA unrolls or keeps the query loop scalar, 8 FMA
lanes and a halving tree, then the chain, where it vectorizes the loop;
the RID term's multiply-adds contracted into FMAs as LLVM contracts them
(`_rid_f32`).  Each FMA is exact in float64 ops (`_fma_chain`,
`_rn32_add`).  A BLAS `matmul` there picked its order by the CPU branch
of the library (MKL's AVX512 sgemv gave identical candidate columns
different totals), which moved near-zero benefits across the greedy's
1e-9 threshold.

* the chain is float32 round-to-nearest at every step, exactly, against a
  rational reference (double rounding through float64 and float32's
  subnormals included);
* on seeded random inputs whose paths win through the RID term, both
  scorers are bit-equal to the JAX package's `_jax_score_secondary` /
  `_jax_score_replace` at every (nq, m, ns) the fleet and session
  fixtures reach and on a grid around the rule's classes (the chain,
  8-lane vectors with and without a scalar epilogue, the unroll limit,
  the ninth candidate column at m = 9);
* on the session test's fixture (`test_torch_session_reference.py`) every
  scorer call of the first two rounds is bit-equal to the reference's;
* a candidate whose paths leave every query unchanged totals exactly what
  the unchanged workload totals under the same sum (benefit 0 against
  it), equal to every other such candidate and to the reference;
* `_cand_costs_torch` and `_cand_costs_stacked_torch` (no product
  reduction) stay bit-equal to `_jax_cand_costs` on the same calls;
* the session test passes in a subprocess under `MKL_CBWR=AVX2`, so the
  dependence on the BLAS branch cannot come back unseen.
"""
import dataclasses
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import cost_engine as ref_ce
import repro_torch.core as pt
from repro_torch.core import cost_engine as ce
from repro_torch.core import cost_model as cm
from torch_port_util import (f32_bits as _bits, port_schema, port_workload,
                             scorer_args)

ROOT = Path(__file__).resolve().parents[1]
BUDGET = 2_000_000          # the session test's


def _rn32_exact(x: Fraction) -> np.float32:
    """float32 round-to-nearest-even of the rational x."""
    f = np.float32(float(x))
    cands = {f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))}
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))
    return np.float32(best)


def _chain_exact(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    out = np.zeros(x.shape[1], np.float32)
    for k in range(x.shape[1]):
        acc = np.float32(0)
        for i in range(x.shape[0]):
            acc = _rn32_exact(Fraction(float(acc))
                              + Fraction(float(w[i])) * Fraction(float(x[i, k])))
        out[k] = acc
    return out


@pytest.mark.parametrize("seed", range(5))
def test_fma_chain_is_exactly_rounded(seed):
    """Random chains (signs, wide exponent ranges; seed 4 runs through
    float32's subnormals, where the fast path hands over to `_rn32_add`)."""
    rng = np.random.default_rng(seed)
    nq, m = int(rng.integers(1, 24)), int(rng.integers(1, 6))
    tiny = 1e-20 if seed == 4 else 1.0
    w = (rng.random(nq) * rng.choice([1e-3, 1.0, 1e3], nq)
         * tiny).astype(np.float32)
    x = (rng.standard_exponential((nq, m))
         * rng.choice([1e-9, 1.0, 1e9], (nq, m)) * tiny).astype(np.float32)
    if seed % 2:
        x = np.where(rng.random((nq, m)) < 0.5, -x, x).astype(np.float32)
    got = ce._fma_chain(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_chain_exact(w, x)))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fma_chain_avoids_double_rounding(sign):
    """a + w*c = 1 + 2^-23 + 2^-24 - 2^-70: a float64 sum rounds it onto
    the float32 midpoint 1 + 2^-23 + 2^-24 and a second rounding to even
    goes up; the exact float32 result is 1 + 2^-23 (the chain's check
    sees the midpoint and redoes the chain with `_rn32_add`)."""
    a = np.float32(sign * (1 + 2.0 ** -23))
    w = np.float32(sign * 2.0 ** -24 * (1 + 2.0 ** -23))
    c = np.float32(1 - 2.0 ** -23)
    twice = np.float32(np.float64(a) + np.float64(w) * np.float64(c))
    got = ce._fma_chain(torch.tensor([1.0, w]),
                        torch.tensor([[a], [c]])).numpy()[0]
    assert got == a != twice


@pytest.fixture(scope="module")
def session_calls():
    """Every scorer call of the port's torch/cpu session on the session
    test's fixture (make_tpch_like(0.15), 12 statements, then a round of 2
    added): (name, float32 inputs, output)."""
    calls = []
    names = ("_score_secondary_torch", "_score_replace_torch",
             "_cand_costs_torch")
    orig = {n: getattr(ce, n) for n in names}

    def wrap(name):
        def run(*args):
            out = orig[name](*args)
            calls.append((name, [a.numpy().copy() for a in args],
                          out.numpy().copy()))
            return out
        return run

    ref_schema = rc.make_tpch_like(scale=0.15, z=0, seed=0)
    schema = port_schema(ref_schema)
    wl = rc.make_scaled_workload(ref_schema, n_statements=12, seed=11)
    extra = rc.make_scaled_workload(ref_schema, n_statements=2, seed=300)
    added = tuple(dataclasses.replace(s, name=f"r0_{s.name}")
                  for s in extra.statements)
    try:
        for n in names:
            setattr(ce, n, wrap(n))
        sess = pt.AdvisorSession(port_workload(wl, schema),
                                 pt.AdvisorOptions(backend="torch",
                                                   device="cpu"))
        sess.recommend(BUDGET)
        sess.add_statements(port_workload(
            rc.Workload(schema=None, statements=list(added)),
            schema).statements)
        sess.recommend(BUDGET)
    finally:
        for n, f in orig.items():
            setattr(ce, n, f)
    return calls


REF = {"_score_secondary_torch": ref_ce._jax_score_secondary,
       "_score_replace_torch": ref_ce._jax_score_replace,
       "_cand_costs_torch": ref_ce._jax_cand_costs}


@pytest.mark.parametrize("name", sorted(REF))
def test_scorers_bit_equal_reference_on_session_fixture(session_calls, name):
    calls = [(a, out) for n, a, out in session_calls if n == name]
    assert calls
    for args, out in calls:
        want = np.asarray(REF[name](*[jnp.asarray(a) for a in args]))
        np.testing.assert_array_equal(_bits(out), _bits(want))


def _new_q_secondary(cur_q, cov, seek, ridr, size_c, beta_c, ncols, q_w):
    npages = torch.clamp_min(size_c, 0.0) / cm.PAGE_BYTES
    rid = (cm.T_IO_RAND * torch.minimum(ridr, npages) + cm.CPU_ROW * ridr
           + beta_c * ridr * ncols[:, None])
    return torch.minimum(cur_q[:, None], torch.minimum(cov, seek + rid))


def test_unchanged_paths_give_the_unchanged_total(session_calls):
    """Candidates that change no query's path: each totals exactly the
    unchanged workload's own total under the same sum (a benefit of 0
    against it), so all of them total one number, the reference's."""
    seen = 0
    for name, args, out in session_calls:
        if name != "_score_secondary_torch":
            continue
        t = [torch.from_numpy(a) for a in args]
        neutral = (_new_q_secondary(*t) == t[0][:, None]).all(0).numpy()
        if not neutral.any():
            continue
        seen += int(neutral.sum())
        nq, m = t[1].shape
        order = ce._xla_sum_order("sec", nq, m, 0)
        own = ce._xla_dot(t[7], t[0][:, None].expand(nq, m),
                          order).numpy()[0]
        assert set(_bits(out[neutral]).tolist()) == {int(_bits(own))}
        want = np.asarray(ref_ce._jax_score_secondary(
            *[jnp.asarray(a) for a in args]))
        np.testing.assert_array_equal(_bits(want[neutral]),
                                      _bits(out[neutral]))
    assert seen > 0


def test_stacked_cost_twin_bit_equal_reference():
    rng = np.random.default_rng(5)
    J, m = 6, 9
    args = [rng.uniform(0.5, 3, (J, m)), rng.uniform(0.2, 5, (J, m)),
            rng.uniform(0.01, 0.5, (J, m)), rng.uniform(0, 50, (J, m)),
            rng.uniform(1e4, 1e7, (J, 1)), rng.uniform(0, 1e-6, (J, 1)),
            rng.integers(1, 8, (J, 1)).astype(float),
            rng.random((J, m)) < 0.6]
    a32 = [np.asarray(a, np.float32) for a in args]
    got = ce._cand_costs_stacked_torch(*[torch.from_numpy(a) for a in a32])
    want = ref_ce._jax_cand_costs_stacked(
        *[jnp.asarray(a) for a in a32[:-1]], jnp.asarray(args[-1]))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_session_reference_passes_under_mkl_avx2_branch():
    env = dict(os.environ, MKL_CBWR="AVX2",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [p for p in [
                       os.environ.get("PYTHONPATH")] if p]))
    test = ("tests/test_torch_session_reference.py::"
            "test_torch_cpu_session_equals_reference_jax_session")
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", test], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-2000:]


# every (nq, m, ns) the fleet and session fixtures reach (the replace
# scorer's m candidates are its nq rows there; ns is the secondary
# scorer's candidate count too)
FIXTURE_REP = [(2, 1, 1), (5, 4, 1)] + [
    (nq, nq, ns) for nq, top in ((8, 12), (9, 12), (11, 15), (13, 18),
                                 (15, 19)) for ns in range(1, top + 1)]
FIXTURE_SEC = {
    2: (3, 6, 9), 5: (3, 6),
    8: (7, 9, 10, 11, 12, 13, 15, 17, 18, 19, 20, 21, 23, 24, 25, 26, 27,
        28, 30, 31, 34, 37),
    9: (12, 14, 15, 18, 19, 22, 24, 26, 27, 29, 32, 35, 38),
    11: (33, 34, 36, 38, 39, 42, 45, 47, 49, 51, 52, 54, 57, 60, 63, 66),
    13: (44, 45, 46, 48, 50, 51, 54, 57, 59, 60, 62, 64, 65, 68, 70, 73, 76,
         79, 82),
    15: (54, 56, 58, 60, 61, 64, 67, 69, 71, 73, 74, 76, 77, 80, 83, 86, 89,
         91, 94, 97)}
# the grid: both sides of the unroll limit, of 8 and 16 queries, of a
# candidate stride of 8 (the epilogue), the m = 9 edge column
GRID_REP = [(nq, m, ns) for nq in (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15)
            for m in (8, 16) for ns in (1, 2, 3, 5, 8)]
GRID_SEC = [(nq, m) for nq in (1, 2, 5, 7, 8, 9, 15, 16, 17, 24, 25, 32, 33)
            for m in (3, 9, 16)]
PROBE = [(8, 8, 2), (8, 8, 3), (8, 16, 3), (16, 16, 2), (24, 8, 3)]
SHAPES = sorted(
    {("rep", *s) for s in FIXTURE_REP + GRID_REP + PROBE}
    | {("sec", nq, m, 0) for nq, ms in FIXTURE_SEC.items() for m in ms}
    | {("sec", nq, m, 0) for nq, m in GRID_SEC})


@pytest.mark.parametrize("scorer,nq,m,ns", SHAPES,
                         ids=lambda v: str(v))
def test_scorers_bit_equal_reference_on_random_inputs(scorer, nq, m, ns):
    rng = np.random.default_rng([nq, m, ns, scorer == "rep"])
    args = scorer_args(scorer, nq, m, ns, rng)
    name = {"rep": "_score_replace_torch",
            "sec": "_score_secondary_torch"}[scorer]
    got = getattr(ce, name)(*[torch.as_tensor(a) for a in args])
    want = np.asarray(REF[name](*[jnp.asarray(a) for a in args]))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


P = ce._Part


@pytest.mark.parametrize("shape,order", [
    (("rep", 8, 8, 2), (P(1, 1, 8, False, "A"),)),    # unrolled: the chain
    (("rep", 8, 8, 3), (P(8, 1, 8, True, "A"),)),     # one 8-lane vector
    (("rep", 8, 16, 3), (P(8, 1, 8, True, "A"),)),
    (("rep", 16, 16, 2), (P(8, 2, 16, True, "A"),)),  # two blocks, no epilogue
    (("rep", 24, 8, 3), (P(8, 2, 16, True, "A"),      # stride 8: a scalar
                         P(1, 1, 8, False, "B"))),    # epilogue
    (("rep", 9, 9, 4), (P(1, 1, 9, False, "B"),)),    # a scalar loop
    (("sec", 15, 40, 0), (P(1, 1, 15, False, "B"),)),
    (("sec", 16, 8, 0), (P(8, 1, 8, True, "B"), P(1, 1, 8, False, "B"))),
    (("sec", 33, 16, 0), (P(8, 4, 32, True, "B"), P(1, 1, 1, False, "B")))])
def test_xla_sum_order_classes(shape, order):
    assert ce._xla_sum_order(*shape) == order
