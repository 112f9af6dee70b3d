"""RLE and NS on the inputs where their CUDA kernels cut the work, against
the JAX package.

RLE's kernel walks pages a warp at a time in 16-byte pairs of values, a
__shfl_up bringing each pair its left neighbour; NS splits each row over a
cluster of blocks.  The edge inputs of `torch_port_util` put runs across
page, pair and warp-step boundaries, at rows per page around those cuts,
and NS's significant-byte edges at every width, at row lengths around its
split.  On the CPU the wrappers run their plain versions, which must be
`==` the reference's NumPy batch formulas (`BATCH_KERNELS`) and its Pallas
kernels (`batched_codec_bytes`, interpret mode; non-negative values and
widths <= 8 only, its envelope).  Integer results: tolerance 0.
test_torch_cuda_kernels.py holds the kernels to these plain versions on
the same inputs on the card.
"""
import numpy as np
import pytest
import torch

from repro.core import compression as ref_comp
from repro.kernels import codec_bytes as ref_ck
from repro_torch.core import compression as comp
from torch_port_util import (I64_MAX, I64_MIN, NS_EDGE_NS, PAGE_EDGE_RPPS,
                             ns_edge_stack, page_edge_n, run_edge_stack)


def port_bytes(method, cols, widths, rpp):
    got = comp.batched_bytes(method, torch.as_tensor(cols),
                             torch.as_tensor(widths), rpp, backend="torch")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    return got.numpy()


def assert_exact(method, cols, widths, rpp, pallas):
    got = port_bytes(method, cols, widths, rpp)
    np.testing.assert_array_equal(
        got, ref_comp.BATCH_KERNELS[method](cols, widths, rpp))
    if pallas:
        assert ref_ck.in_envelope(cols, widths)
        np.testing.assert_array_equal(
            got, ref_ck.batched_codec_bytes(method, cols, widths, rpp))


@pytest.mark.parametrize("rpp", PAGE_EDGE_RPPS)
@pytest.mark.parametrize("pages", ["ragged", "n < rpp"])
def test_rle_page_edges_equal_reference(rpp, pages):
    """Non-negative runs across page, pair and warp-step boundaries: the
    plain RLE equals NumPy and the Pallas kernel."""
    cols, widths = run_edge_stack(page_edge_n(rpp, pages), rpp, rpp,
                                  signed=False)
    assert_exact("RLE", cols, widths, rpp, pallas=True)


@pytest.mark.parametrize("rpp", PAGE_EDGE_RPPS)
@pytest.mark.parametrize("pages", ["ragged", "n < rpp"])
def test_rle_signed_page_edges_equal_numpy(rpp, pages):
    """With the int64 extremes and top-bit-only differences (outside the
    Pallas kernel's envelope): the plain RLE equals NumPy."""
    cols, widths = run_edge_stack(page_edge_n(rpp, pages), rpp, rpp + 1,
                                  signed=True)
    assert_exact("RLE", cols, widths, rpp, pallas=False)


def test_rle_page_boundary_starts_a_run():
    """A value that runs on across a page boundary is a new run on the
    next page: rows of one value cost one run on every page."""
    cols = np.full((1, 1000), 9, dtype=np.int64)
    got = port_bytes("RLE", cols, np.array([8]), 273)
    # four pages of one run each: min(1 * (8 + 2) + 16, rows * 8 + 16)
    assert got.tolist() == [4 * 26]
    assert_exact("RLE", cols, np.array([8]), 273, pallas=True)


@pytest.mark.parametrize("n", NS_EDGE_NS)
def test_ns_edges_equal_reference(n):
    """Significant-byte edges at every width, n around the kernel's row
    split: the plain NS equals NumPy and the Pallas kernel."""
    cols, widths = ns_edge_stack(n, signed=False)
    assert_exact("NS", cols, widths, 1, pallas=True)


@pytest.mark.parametrize("n", NS_EDGE_NS)
def test_ns_signed_edges_equal_numpy(n):
    """With -1, INT64_MIN and -2^(8k) (8 significant bytes each): the plain
    NS equals NumPy."""
    cols, widths = ns_edge_stack(n, signed=True)
    assert_exact("NS", cols, widths, 1, pallas=False)


def test_ns_rounds_odd_half_byte_sums_up():
    """One value of 1 byte at width 8 is 3 half-bytes, 2 bytes; three are
    9 half-bytes, 5 bytes."""
    widths = np.array([8, 8])
    cols = np.array([[255, 0, 0], [255, 255, 255]], dtype=np.int64)
    got = port_bytes("NS", cols[:, :1], widths, 1)
    assert got.tolist() == [2, 2]
    assert port_bytes("NS", cols, widths, 1).tolist() == [5, 5]
    assert_exact("NS", cols, widths, 1, pallas=True)


def sig_bytes_clz(u: int) -> int:
    """The NS kernel's significant bytes of a uint64: max(1, (71 - clz) >> 3),
    clz the count of leading zero bits of 64."""
    return max(1, (71 - (64 - u.bit_length())) >> 3)


def test_sig_bytes_clz_formula_equals_plain():
    """The kernel's count from leading zeros equals the plain version's
    seven compares at every bit position (2^b - 1, 2^b, 2^b + 1), every
    byte edge, and the int64 extremes read as uint64."""
    vals = {0, 1, I64_MAX, I64_MIN, -1}
    for b in range(1, 64):
        vals |= {(1 << b) - 1, 1 << b, (1 << b) + 1}
    vals = sorted(v for v in vals if I64_MIN <= v <= I64_MAX)
    vals += [-(1 << (8 * k)) for k in range(1, 8)]
    from repro_torch.kernels import codec_bytes as cb
    plain = cb._sig_bytes(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert [sig_bytes_clz(v % (1 << 64)) for v in vals] == plain
