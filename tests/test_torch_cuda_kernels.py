"""The port's four CUDA kernels against their plain PyTorch versions, on
the card.

Every test here is marked `cuda` and skips on a host without a CUDA card;
this file imports only `repro_torch` (no JAX), so it also runs on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: NS and LDICT bit-equal (integers); `prob_within` and
`fused_score` p within atol 1e-6 and cm / cs within rtol 1e-6 (the same
IEEE float ops; only CUDA's erff and PyTorch's erf may differ by an ulp);
winners equal; prob consistency bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compression as comp
from repro_torch.kernels import codec_bytes as cb, launch_counts
from repro_torch.kernels import planner_score as ps

E = 0.1


def f32(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def random_rvs(nc, k, nf, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.85, 1.15, size=(nc, k, nf))
    s = rng.uniform(0.0, 0.08, size=(nc, k, nf))
    dm = rng.uniform(0.95, 1.05, size=(nc, 1))
    ds = rng.uniform(0.0, 0.05, size=(nc, 1))
    return m, s, dm, ds * ds + dm * dm, dm * dm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rpp,top", [
    ((126, 6000), 273, 1 << 32), ((1, 5000), 1638, 1 << 60),
    ((5, 1), 273, 256), ((3, 777), 1, 1 << 16), ((9, 1000), 1638, 1 << 10)])
def test_cuda_kernels_equal_plain(cuda, shape, rpp, top):
    rng = np.random.default_rng(shape[1])
    cols = torch.as_tensor(rng.integers(-top, top, size=shape), device=cuda)
    widths = torch.as_tensor(rng.integers(1, 9, size=shape[0]), device=cuda)
    before = launch_counts()
    assert torch.equal(cb.ns_bytes(cols, widths),
                       cb.ns_bytes_plain(cols, widths))
    assert torch.equal(cb.ldict_bytes(cols, widths, rpp),
                       cb.ldict_bytes_plain(cols, widths, rpp))
    after = launch_counts()
    assert after["ns_bytes"] == before["ns_bytes"] + 1
    assert after["ldict_bytes"] == before["ldict_bytes"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("method", ("GDICT", "PREFIX", "RLE"))
def test_cuda_unported_methods_raise(cuda, method):
    cols = torch.zeros((2, 10), dtype=torch.int64, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        comp.batched_bytes(method, cols, torch.ones(2, dtype=torch.int64,
                                                    device=cuda), 4,
                           backend="torch")


@pytest.mark.cuda
def test_cuda_prob_within_close_to_plain(cuda):
    rng = np.random.default_rng(0)
    means = f32(np.r_[rng.uniform(0.3, 2.5, 3000), [1.0, 0.2]], cuda)
    stds = f32(np.r_[rng.uniform(0.0, 0.8, 3000), [0.0, 0.0]], cuda)
    got = ps.prob_within(means, stds, E)
    want = ps.prob_within_plain(means, stds, E)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("nc,k,nf", [(14, 11, 5), (1, 1, 5), (300, 3, 5)])
def test_cuda_fused_score_close_to_plain(cuda, nc, k, nf):
    m, s, dm, vt, mq = random_rvs(nc, k, nf, seed=nc)
    rng = np.random.default_rng(k)
    mask67 = torch.as_tensor(rng.random((nc, nf)) < 0.5, device=cuda)
    pre9 = ~mask67 & torch.as_tensor(rng.random((nc, nf)) < 0.5,
                                     device=cuda)
    args = (f32(m, cuda), f32(s, cuda), f32(dm.ravel(), cuda),
            f32(vt.ravel(), cuda), f32(mq.ravel(), cuda), mask67, pre9,
            f32(rng.uniform(1, 9, (nc, nf)), cuda))
    got = ps.fused_score(*args, E, 0.3)
    want = ps.fused_score_plain(*args, E, 0.3)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0.0)
    assert float((got[2] - want[2]).abs().max()) <= 1e-6
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    again = ps.prob_within(got[0], got[1], E)
    mask = mask67 | pre9
    assert torch.equal(got[2][mask], again[mask])
