"""The port's blockwise quantization and dequant-matmul against the JAX
package, on the CPU (the port's wrappers run their plain versions on CPU
tensors; the JAX side runs its Pallas kernels in interpret mode through
`kernels/ops.py`, and its pure-jnp oracles in `kernels/ref.py`).

Inputs are made with NumPy from a seed and handed to both packages.
Tolerances are `tests/test_kernels.py`'s: against the Pallas kernels,
|dq| <= 1 at <= 0.1 % of positions and scales rtol 1e-5 (an ulp of the
scale may flip a round-half boundary); against the oracle, q exact and
scales rtol 1e-6; dequant-matmul rtol and atol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import launch_counts
from repro_torch.kernels import quantize_blockwise as qb

SHAPES_2D = [(8, 128), (32, 256), (256, 512), (64, 384), (128, 1024)]
DTYPES = ["float32", "bfloat16"]
BLOCKS = [64, 128]


def inputs(shape, dtype, seed=0, scale=3.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


def assert_close_to_kernel(q, s, q_k, s_k):
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(q_k, np.int32))
    assert dq.max() <= 1
    assert (dq != 0).mean() <= 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", BLOCKS)
def test_quantize_matches_jax(shape, dtype, block):
    jx, tx = inputs(shape, dtype)
    q, s = qb.quantize_blockwise(tx, block=block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert_close_to_kernel(q, s, *ops.quantize_blockwise(jx, block=block))
    q_r, s_r = ref.quantize_blockwise(jx, block=block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 2, 96), (3, 5, 7, 130), (1, 128),
                                   (5, 7), (2, 130)])
def test_quantize_any_rank_and_ragged_last_dim(shape):
    jx, tx = inputs(shape, "float32", seed=1, scale=1.0)
    q, s = qb.quantize_blockwise(tx, block=64)
    assert q.shape == tx.shape
    assert s.shape == tx.shape[:-1] + (-(-shape[-1] // 64),)
    q_r, s_r = ref.quantize_blockwise(jx, block=64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-6)
    assert_close_to_kernel(q, s, *ops.quantize_blockwise(jx, block=64))


def test_quantize_rounds_half_to_even_and_zero_blocks():
    # absmax 127 gives scale 1, so x / scale lands exactly on .5 values
    x = np.zeros((3, 128), np.float32)
    x[0, 0] = 127.0
    x[0, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    x[2, :4] = [1e-30, -1e-30, 0.0, 0.0]          # all but zero
    q, s = qb.quantize_blockwise(torch.from_numpy(x))
    q_r, s_r = ref.quantize_blockwise(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    assert q[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
    assert q[1].abs().max() == 0 and s[1, 0] == np.float32(1e-12) / 127


def test_quantize_cpu_route_is_the_plain_version_and_counts_nothing():
    _, tx = inputs((16, 300), "float32", seed=2)
    before = launch_counts()["quantize_blockwise"]
    q, s = qb.quantize_blockwise(tx)
    q_p, s_p = qb.quantize_blockwise_plain(tx)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert launch_counts()["quantize_blockwise"] == before


def test_quantize_rejects_other_dtypes():
    with pytest.raises(ValueError):
        qb.quantize_blockwise(torch.zeros((2, 128), dtype=torch.float64))


def weights(k, n, m, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    qw, s_row = ref.quantize_blockwise(jnp.asarray(w).T, block=128)
    return a, np.asarray(qw).T, np.asarray(s_row).T, w


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (32, 256, 256),
                                   (16, 384, 128), (64, 512, 256)])
def test_dequant_matmul_matches_jax(m, k, n):
    a, qw, s, _ = weights(k, n, m, seed=m + k)
    got = dm.dequant_matmul(torch.from_numpy(a), torch.from_numpy(qw.copy()),
                            torch.from_numpy(s.copy()))
    want = ops.dequant_matmul(jnp.asarray(a), jnp.asarray(qw), jnp.asarray(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    oracle = ref.dequant_matmul(jnp.asarray(a), jnp.asarray(qw),
                                jnp.asarray(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-4,
                               atol=1e-4)


def test_dequant_matmul_ragged_m_and_n_close_to_float():
    a, qw, s, w = weights(256, 70, 3, seed=5)
    got = dm.dequant_matmul(torch.from_numpy(a), torch.from_numpy(qw.copy()),
                            torch.from_numpy(s.copy())).numpy()
    exact = a @ w
    rel = np.abs(got - exact) / (np.abs(exact) + 1e-3)
    assert got.shape == (3, 70) and np.median(rel) < 0.02


def test_dequant_matmul_rejects_k_off_the_block():
    a = torch.zeros((4, 200))
    qw = torch.zeros((200, 64), dtype=torch.int8)
    s = torch.ones((1, 64))
    with pytest.raises(ValueError, match="multiple of block"):
        dm.dequant_matmul(a, qw, s)
    with pytest.raises(ValueError, match="multiple of block"):
        dm.dequant_matmul_plain(a, qw, s)
