"""The port's codec-size kernels (all five methods) against the JAX
package.

On the CPU the wrappers of `repro_torch.kernels.codec_bytes` run their
plain PyTorch versions; these must be `==` the reference's NumPy batch
formulas (`repro.core.compression.BATCH_KERNELS`) and its Pallas kernels
(`repro.kernels.codec_bytes.batched_codec_bytes`, interpret mode) on every
input.  Integer results: every comparison is exact (tolerance 0).  Negative
values lie outside the Pallas kernels' envelope, so they are compared with
NumPy only.  test_torch_cuda_kernels.py holds the CUDA kernels against
these plain versions on the card.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import compression as ref_comp
from repro.kernels import codec_bytes as ref_ck
from repro_torch.core import compression as comp
from repro_torch.kernels import codec_bytes as cb, launch_counts

# NS and LDICT first: their tests' seeds derive from this position
METHODS = ("NS", "LDICT", "GDICT", "PREFIX", "RLE")


def port_bytes(method, cols, widths, rpp):
    got = comp.batched_bytes(
        method, torch.as_tensor(np.asarray(cols, dtype=np.int64)),
        torch.as_tensor(np.asarray(widths, dtype=np.int64)), rpp,
        backend="torch")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    return got.numpy()


def ref_numpy(method, cols, widths, rpp):
    return ref_comp.BATCH_KERNELS[method](np.asarray(cols, dtype=np.int64),
                                          np.asarray(widths, dtype=np.int64),
                                          rpp)


def assert_exact(method, cols, widths, rpp, pallas=True):
    got = port_bytes(method, cols, widths, rpp)
    np.testing.assert_array_equal(got, ref_numpy(method, cols, widths, rpp))
    if pallas:
        np.testing.assert_array_equal(
            got, ref_ck.batched_codec_bytes(
                method, np.asarray(cols, dtype=np.int64),
                np.asarray(widths, dtype=np.int64), rpp))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape,rpp", [
    ((1, 1), 1),          # single value, single-row pages
    ((3, 7), 3),          # partial last page
    ((5, 64), 16),        # exact pages
    ((8, 129), 128),      # one row past a lane boundary
    ((17, 200), 1000),    # rpp > nrows: one page
    ((4, 333), 1),        # rpp=1: every row its own page
    ((3, 3000), 273),     # the advisor's widest rows-per-page at SF1
    ((2, 4000), 1638),    # the largest rows-per-page (8192 // 5)
])
def test_random_values_equal_reference(method, shape, rpp):
    rng = np.random.default_rng([METHODS.index(method), *shape, rpp])
    cols = rng.integers(0, 1 << 16, size=shape)
    widths = rng.integers(1, 9, size=shape[0])
    assert_exact(method, cols, widths, rpp)


@pytest.mark.parametrize("method", METHODS)
def test_values_beyond_32_and_56_bits(method):
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 1 << 62, size=(6, 300))
    cols[0] = 1 << 32
    cols[1] = (1 << 56) + rng.integers(0, 4, size=300)
    cols[2] = rng.integers(0, 3, size=300) << 56
    cols[3] = (1 << 63) - 1
    assert_exact(method, cols, [8, 8, 8, 8, 7, 5], 7)


@pytest.mark.parametrize("method", METHODS)
def test_constant_and_degenerate_rows(method):
    cols = np.zeros((4, 500), dtype=np.int64)
    cols[1] = 255
    cols[2] = 256
    cols[3, ::2] = 65537
    assert_exact(method, cols, [1, 1, 2, 4], 273)


@pytest.mark.parametrize("method", METHODS)
def test_negative_values_equal_numpy(method):
    rng = np.random.default_rng(5)
    cols = rng.integers(-(1 << 40), 1 << 40, size=(5, 400))
    cols[0] = -1
    cols[1, :200] = np.iinfo(np.int64).min
    assert_exact(method, cols, [1, 2, 4, 8, 8], 9, pallas=False)


@pytest.mark.parametrize("method", METHODS)
def test_empty_stacks(method):
    assert port_bytes(method, np.zeros((3, 0)), [1, 2, 3], 5).tolist() \
        == [0, 0, 0]
    assert port_bytes(method, np.zeros((0, 4)), [], 5).shape == (0,)


@pytest.mark.parametrize("method", METHODS)
def test_port_numpy_formulas_equal_reference(method):
    """The port's own copy of the NumPy batch formulas (the numpy
    backend, and the host route of the unported methods) stays equal to
    the reference's."""
    rng = np.random.default_rng(11)
    cols = rng.integers(0, 1 << 20, size=(6, 700))
    cols[2] = 42
    widths = rng.integers(1, 9, size=6)
    for rpp in (1, 50, 273, 1000):
        want = ref_numpy(method, cols, widths, rpp)
        np.testing.assert_array_equal(
            comp.batched_bytes(method, cols, widths, rpp), want)
        np.testing.assert_array_equal(
            port_bytes(method, cols, widths, rpp), want)


def test_cpu_route_launches_nothing():
    before = launch_counts()
    cols = torch.arange(600, dtype=torch.int64).reshape(2, 300)
    widths = torch.tensor([2, 4])
    cb.ns_bytes(cols, widths)
    cb.gdict_bytes(cols, widths)
    cb.ldict_bytes(cols, widths, 7)
    cb.prefix_bytes(cols, widths, 7)
    cb.rle_bytes(cols, widths, 7)
    assert launch_counts() == before


def test_wrappers_reject_bad_inputs():
    cols = torch.zeros((2, 10), dtype=torch.int64)
    with pytest.raises(ValueError):
        cb.ns_bytes(cols.to(torch.int32), torch.tensor([1, 2]))
    with pytest.raises(ValueError):
        cb.ns_bytes(cols, torch.tensor([1, 2, 3]))
    with pytest.raises(ValueError):
        cb.ldict_bytes(cols, torch.tensor([1, 2]), 0)
    with pytest.raises(ValueError):
        cb.prefix_bytes(cols, torch.tensor([1, 2]), 0)
    with pytest.raises(ValueError):
        cb.rle_bytes(cols.to(torch.float64), torch.tensor([1, 2]), 3)
    with pytest.raises(ValueError):
        cb.gdict_bytes(cols, torch.tensor([1, 2], dtype=torch.int32))


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 5), n=st.integers(1, 300), rpp=st.integers(1, 64),
       top=st.sampled_from([2, 1 << 8, 1 << 16, 1 << 33, 1 << 60]),
       w=st.integers(1, 8), seed=st.integers(0, 2 ** 16))
def test_property_twin(m, n, rpp, top, w, seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, top, size=(m, n))
    widths = np.full(m, w)
    for method in METHODS:
        np.testing.assert_array_equal(port_bytes(method, cols, widths, rpp),
                                      ref_numpy(method, cols, widths, rpp))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("rpp", [1, 7, 273, 1000])
def test_mixed_sign_pages_equal_numpy(method, rpp):
    """Pages holding negative and non-negative values together: PREFIX
    takes each page's signed min and max, as the NumPy formula does."""
    rng = np.random.default_rng(rpp)
    cols = rng.integers(-300, 300, size=(4, 600))
    cols[1] = rng.integers(-2, 2, size=600)
    cols[2, ::3] = np.iinfo(np.int64).max
    cols[3] = np.sort(cols[3])
    assert_exact(method, cols, [1, 2, 8, 4], rpp, pallas=False)


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 5), n=st.integers(1, 300), rpp=st.integers(1, 64),
       lo=st.sampled_from([-(1 << 62), -(1 << 20), -256, -1]),
       w=st.integers(1, 8), seed=st.integers(0, 2 ** 16))
def test_property_twin_signed(m, n, rpp, lo, w, seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(lo, -lo, size=(m, n))
    widths = np.full(m, w)
    for method in METHODS:
        np.testing.assert_array_equal(port_bytes(method, cols, widths, rpp),
                                      ref_numpy(method, cols, widths, rpp))
