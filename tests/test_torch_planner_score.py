"""The port's planner-score kernels (`prob_within`, `fused_score`) against
the JAX package.

On the CPU the wrappers of `repro_torch.kernels.planner_score` run their
plain PyTorch versions.  Tolerances, as the reference's own parity suite
states them (float32 arithmetic and a different erf on each side):
`prob_within` atol 2e-5; `fused_score` cm rtol 1e-5, cs rtol 1e-4
(atol 1e-6), p atol 5e-5; winners equal.  Within the port two properties
hold bitwise: `prob_within` recomputes `fused_score`'s p from its own
(cm, cs), and (1, 0) K-padding is invisible.  test_torch_cuda_kernels.py
holds the CUDA kernels against these plain versions on the card.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import errors as ref_err
from repro.kernels import planner_score as ref_ps
from repro_torch.core import errors as err
from repro_torch.kernels import launch_counts, planner_score as ps

E, Q = 0.1, 0.9


def f32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def port_prob(means, stds, e):
    return ps.prob_within(f32(means), f32(stds), e).numpy().astype(
        np.float64)


def random_rvs(nc, k, nf, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.85, 1.15, size=(nc, k, nf))
    s = rng.uniform(0.0, 0.08, size=(nc, k, nf))
    dm = rng.uniform(0.95, 1.05, size=(nc, 1))
    ds = rng.uniform(0.0, 0.05, size=(nc, 1))
    return m, s, dm, ds * ds + dm * dm, dm * dm


def port_fused(m, s, dm, vt, mq, mask67, pre9, extra, e, q):
    nc, _, nf = np.shape(m)
    out = ps.fused_score(
        f32(m), f32(s), f32(np.ravel(dm)), f32(np.ravel(vt)),
        f32(np.ravel(mq)), torch.as_tensor(np.asarray(mask67, dtype=bool)),
        None if pre9 is None else torch.as_tensor(np.asarray(pre9,
                                                             dtype=bool)),
        None if extra is None else f32(extra), e, q)
    return tuple(t.numpy() for t in out)


def staged_reference(m, s, dm, vt, mq, mask, e):
    """float64 NumPy re-expression of the fused fold (the reference's)."""
    e_prod, v_term, e2 = ref_err.goodman_fold(m, s, axis=1)
    cm = e_prod * dm
    cs = np.sqrt(np.maximum(v_term * vt - e2 * mq, 0.0))
    p = np.zeros_like(cm)
    ii = mask.nonzero()
    p[ii] = ref_err.prob_within_batch(cm[ii], cs[ii], e)
    return cm, cs, p


class TestProbWithin:
    def test_indicator_branch_exact(self):
        lo, hi = 1.0 / (1.0 + E), 1.0 + E
        means = np.array([0.2, lo, 1.0, hi, 1.6])
        stds = np.zeros_like(means)
        got = port_prob(means, stds, E)
        assert set(np.unique(got)) <= {0.0, 1.0}
        np.testing.assert_array_equal(got, ref_ps.prob_within(means, stds,
                                                              E))
        np.testing.assert_array_equal(
            got[[0, 2, 4]], ref_err.prob_within_batch(means, stds, E)[[0, 2,
                                                                       4]])

    @pytest.mark.parametrize("n,e", [(1, 0.05), (7, 0.1), (128, 0.2),
                                     (1000, 0.5)])
    def test_erf_branch_close(self, n, e):
        rng = np.random.default_rng(n)
        means = rng.uniform(0.5, 1.5, size=n)
        stds = rng.uniform(1e-6, 0.5, size=n)
        got = port_prob(means, stds, e)
        np.testing.assert_allclose(
            got, ref_err.prob_within_batch(means, stds, e), atol=2e-5)
        np.testing.assert_allclose(got, ref_ps.prob_within(means, stds, e),
                                   atol=2e-5)

    def test_shapes_and_empty(self):
        assert ps.prob_within(torch.zeros(0), torch.zeros(0),
                              E).shape == (0,)
        assert ps.prob_within(torch.ones(3, 4), torch.zeros(3, 4),
                              E).shape == (3, 4)
        with pytest.raises(ValueError):
            ps.prob_within(torch.ones(3, dtype=torch.float64),
                           torch.zeros(3, dtype=torch.float64), E)

    def test_numpy_scorer_equals_reference_bitwise(self):
        """The numpy backend's exact-erf float64 scorer is the
        reference's, bit for bit."""
        rng = np.random.default_rng(9)
        means = rng.uniform(0.3, 2.0, size=500)
        stds = np.where(rng.random(500) < 0.1, 0.0,
                        rng.uniform(0.0, 0.6, size=500))
        for e in (0.05, 0.5):
            np.testing.assert_array_equal(
                err.prob_within_batch(means, stds, e),
                ref_err.prob_within_batch(means, stds, e))

    @settings(max_examples=25, deadline=None)
    @given(st.floats(0.3, 2.5), st.floats(0.0, 1.0), st.floats(0.02, 0.5))
    def test_property_twin(self, mean, std, e):
        got = float(port_prob(np.array([mean]), np.array([std]), e)[0])
        want = float(ref_err.prob_within_batch(np.array([mean]),
                                               np.array([std]), e)[0])
        assert abs(got - want) <= 3e-5
        assert 0.0 <= got <= 1.0


class TestFusedScore:
    def test_close_to_float64_and_pallas_reference(self):
        nc, k, nf = 11, 3, 5
        m, s, dm, vt, mq = random_rvs(nc, k, nf, seed=1)
        mask67 = np.ones((nc, nf), dtype=bool)
        mask67[2] = False
        cm, cs, p, _, _ = port_fused(m, s, dm, vt, mq, mask67, None, None,
                                     E, Q)
        cm_r, cs_r, p_r = staged_reference(m, s, dm, vt, mq, mask67, E)
        np.testing.assert_allclose(cm, cm_r, rtol=1e-5)
        np.testing.assert_allclose(cs, cs_r, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(p, p_r, atol=5e-5)
        assert (p[2] == 0.0).all()
        cm_j, cs_j, p_j, _, _ = ref_ps.fused_score(m, s, dm, vt, mq, mask67,
                                                   None, None, E, Q)
        np.testing.assert_allclose(cm, cm_j, rtol=1e-5)
        np.testing.assert_allclose(cs, cs_j, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(p, p_j, atol=5e-5)

    def test_prob_consistency_bitwise(self):
        nc, k, nf = 9, 2, 4
        m, s, dm, vt, mq = random_rvs(nc, k, nf, seed=2)
        mask67 = np.ones((nc, nf), dtype=bool)
        cm, cs, p, _, _ = port_fused(m, s, dm, vt, mq, mask67, None, None,
                                     E, Q)
        again = ps.prob_within(torch.from_numpy(cm), torch.from_numpy(cs),
                               E).numpy()
        np.testing.assert_array_equal(p, again)

    def test_kpad_invariance_bitwise(self):
        nc, nf = 6, 3
        m, s, dm, vt, mq = random_rvs(nc, 2, nf, seed=3)
        mask67 = np.ones((nc, nf), dtype=bool)
        pad_m = np.concatenate([m, np.ones((nc, 3, nf))], axis=1)
        pad_s = np.concatenate([s, np.zeros((nc, 3, nf))], axis=1)
        a = port_fused(m, s, dm, vt, mq, mask67, None, None, E, Q)
        b = port_fused(pad_m, pad_s, dm, vt, mq, mask67, None, None, E, Q)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    @pytest.mark.parametrize("seed", [4, 5, 6])
    def test_winners_equal_reference(self, seed):
        nc, k, nf = 14, 2, 6
        m, s, dm, vt, mq = random_rvs(nc, k, nf, seed=seed)
        rng = np.random.default_rng(seed)
        mask67 = np.zeros((nc, nf), dtype=bool)
        mask67[: nc // 2] = rng.random((nc // 2, nf)) < 0.6
        pre9 = np.zeros((nc, nf), dtype=bool)
        pre9[nc // 2:] = True
        extra = np.abs(rng.normal(size=(nc, nf))) + 0.1
        extra[-1] = extra[-2]             # a tie: the first index wins
        cm, cs, p, w6, w9 = port_fused(m, s, dm, vt, mq, mask67, pre9,
                                       extra, E, 0.2)
        _, _, _, rw6, rw9 = ref_ps.fused_score(m, s, dm, vt, mq, mask67,
                                               pre9, extra, E, 0.2)
        np.testing.assert_array_equal(w6, rw6)
        np.testing.assert_array_equal(w9, rw9)
        sat = p >= np.float32(0.2)
        for f in range(nf):
            elig = mask67[:, f] & sat[:, f]
            if elig.any():
                pe = np.where(elig, p[:, f], -1.0)
                assert w6[f] == int(np.flatnonzero(pe == pe.max())[0])
            else:
                assert w6[f] == ps.NO_WINNER

    def test_empty_masks_give_no_winner(self):
        m, s, dm, vt, mq = random_rvs(4, 2, 3, seed=8)
        none = np.zeros((4, 3), dtype=bool)
        *_, w6, w9 = port_fused(m, s, dm, vt, mq, none, none,
                                np.ones((4, 3)), E, Q)
        assert (w6 == ps.NO_WINNER).all() and (w9 == ps.NO_WINNER).all()

    def test_cpu_route_launches_nothing(self):
        before = launch_counts()
        m, s, dm, vt, mq = random_rvs(3, 2, 2, seed=7)
        port_fused(m, s, dm, vt, mq, np.ones((3, 2), dtype=bool), None,
                   None, E, Q)
        port_prob([1.0], [0.1], E)
        assert launch_counts() == before
