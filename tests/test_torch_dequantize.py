"""The port's blockwise dequantization against the JAX package, on the CPU.

On a CPU tensor the port's wrapper runs its plain version; the JAX side
runs its Pallas kernel in interpret mode (`kernels/ops.py`) and its jnp
oracle (`kernels/ref.py`).  q and the scales come from the JAX oracle's
quantization of NumPy data made from a seed, so both packages see the same
inputs.  `q * scale` is one rounded float32 multiply and the bfloat16 cast
rounds to nearest even in both packages, so the outputs agree BITWISE, in
float32 and in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels import quantize_blockwise as qb

SHAPES = [(8, 64), (4, 128), (6, 200), (3, 384), (200,), (384,),
          (2, 3, 200), (2, 2, 3, 384), (5, 7), (2, 3, 130)]
DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]


def quantized(shape, seed, block=128, zero_block=False):
    """JAX-quantized q and scales of seeded data, as NumPy arrays."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(
        np.float32)
    if zero_block:
        x[..., :block] = 0.0
    q, s = ref.quantize_blockwise(jnp.asarray(x), block)
    return np.array(q), np.array(s)


def bits(a):
    """float32 / bfloat16 values as integers, to compare bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_dequantize_bitwise_equal_to_jax(shape, name, tdt, jdt):
    q, s = quantized(shape, seed=len(shape) + shape[-1],
                     zero_block=shape[-1] > 128)
    got = qb.dequantize_blockwise(torch.from_numpy(q), torch.from_numpy(s),
                                  dtype=tdt)
    assert got.shape == q.shape and got.dtype == tdt
    oracle = ref.dequantize_blockwise(jnp.asarray(q), jnp.asarray(s),
                                      dtype=jdt)
    kernel = ops.dequantize_blockwise(jnp.asarray(q), jnp.asarray(s),
                                      dtype=jdt)
    np.testing.assert_array_equal(bits(got), bits(oracle))
    np.testing.assert_array_equal(bits(got), bits(kernel))


@pytest.mark.parametrize("block", [64, 128])
def test_dequantize_block_sizes_and_all_zero_block(block):
    q, s = quantized((4, 256), seed=block, block=block, zero_block=True)
    assert (q[:, :block] == 0).all() and (s[:, 0] == np.float32(1e-12) /
                                          np.float32(127)).all()
    got = qb.dequantize_blockwise(torch.from_numpy(q), torch.from_numpy(s),
                                  block=block)
    assert (got[:, :block] == 0).all()
    kernel = ops.dequantize_blockwise(jnp.asarray(q), jnp.asarray(s),
                                      block=block)
    np.testing.assert_array_equal(bits(got), bits(kernel))


@pytest.mark.parametrize("seed,block", [(0, 64), (3, 128), (7, 128)])
def test_roundtrip_is_a_fixpoint(seed, block):
    """quantize(dequantize(quantize(x))) == quantize(x), as the JAX
    package's own kernel test asserts, and the port's round trip equals
    the JAX one."""
    x = (np.random.default_rng(seed).standard_normal((16, 256))).astype(
        np.float32)
    q1, s1 = qb.quantize_blockwise(torch.from_numpy(x), block)
    x1 = qb.dequantize_blockwise(q1, s1, block)
    q2, s2 = qb.quantize_blockwise(x1, block)
    x2 = qb.dequantize_blockwise(q2, s2, block)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-5, atol=1e-6)
    assert (q1.int() - q2.int()).abs().max() <= 1
    jq, js = ops.quantize_blockwise(jnp.asarray(x), block=block)
    jx1 = ops.dequantize_blockwise(jq, js, block=block)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), rtol=1e-5,
                               atol=1e-6)


def test_dequantize_cpu_route_is_the_plain_version_and_counts_nothing():
    q, s = quantized((16, 300), seed=2)
    tq, ts = torch.from_numpy(q), torch.from_numpy(s)
    before = launch_counts()["dequantize_blockwise"]
    got = qb.dequantize_blockwise(tq, ts)
    assert torch.equal(got, qb.dequantize_blockwise_plain(tq, ts))
    assert launch_counts()["dequantize_blockwise"] == before


def test_dequantize_rejects_bad_inputs():
    q = torch.zeros((2, 200), dtype=torch.int8)
    s = torch.ones((2, 2))
    with pytest.raises(ValueError, match="int8"):
        qb.dequantize_blockwise(q.float(), s)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qb.dequantize_blockwise(q, s, dtype=torch.float16)
    with pytest.raises(ValueError, match="do not fit"):
        qb.dequantize_blockwise(q, torch.ones((2, 1)))
