"""The port's grouped blockwise dequantization and its bucketed, in-place
q8 gradient wire against the JAX package, on the CPU.

On CPU tensors `dequantize_blockwise_group` runs its plain version, one
`dequantize_blockwise_plain` per item written into the item's output; the
JAX side runs its Pallas kernel `dequantize_blockwise_2d` in interpret mode
and its jnp oracle `ref.dequantize_blockwise`, per tensor.  q and the
scales come from the JAX oracle's quantization of NumPy data made from a
seed.  `q * scale` is one rounded float32 multiply and the bfloat16 cast
rounds to nearest even in both packages, so the outputs agree BITWISE.

The wire: the reference maps quantize-then-dequantize over the gradient
tree (`repro/train/step.py`, its `qdq`); the port quantizes each gradient
and dequantizes a bucket of them in one grouped call, into the gradients'
own storage.  Same bits in float32, whatever the buckets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.quantize_blockwise import dequantize_blockwise_2d
from repro_torch.kernels import launch_counts
from repro_torch.kernels import quantize_blockwise as qb
from repro_torch.train import step

DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]
# 2-D shapes the Pallas kernel's tiling takes (rows <= 256 or a multiple;
# columns <= 512 and a multiple of the block, or a multiple of 512)
PALLAS_SHAPES = [(8, 128), (16, 256), (4, 512), (2, 1024), (256, 384)]
# any rank, ragged last blocks, last dimensions under one block
ANY_SHAPES = [(2048,), (300,), (7,), (32, 64), (9, 130), (3, 5, 200),
              (2, 3, 4, 384), (2, 2, 2, 129)]


def quantized(shape, seed):
    """JAX-quantized q and scales of seeded data, as NumPy arrays."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(
        np.float32)
    if shape[-1] > 128:
        x[..., :128] = 0.0                       # an all-zero block
    q, s = ref.quantize_blockwise(jnp.asarray(x))
    return np.array(q), np.array(s)


def bits(a):
    """float32 / bfloat16 values as integers, to compare bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def group_of(shapes, tdt, seed=0):
    """(NumPy q, NumPy scales, torch items) for seeded data of `shapes`;
    every output starts as NaN, so an element left unwritten shows."""
    qs = [quantized(sh, seed + i) for i, sh in enumerate(shapes)]
    items = [(torch.from_numpy(q), torch.from_numpy(s),
              torch.full(q.shape, float("nan"), dtype=tdt)) for q, s in qs]
    return qs, items


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
def test_group_bitwise_equal_to_the_pallas_kernel(name, tdt, jdt, plain):
    qs, items = group_of(PALLAS_SHAPES, tdt, seed=11)
    group = qb.dequantize_blockwise_group_plain if plain else \
        qb.dequantize_blockwise_group
    group(items)
    for (q, s), (_, _, out) in zip(qs, items):
        kernel = dequantize_blockwise_2d(jnp.asarray(q), jnp.asarray(s),
                                         dtype=jdt, interpret=True)
        np.testing.assert_array_equal(bits(out), bits(kernel))


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("shapes", [ANY_SHAPES, PALLAS_SHAPES + ANY_SHAPES],
                         ids=["any rank", "mixed"])
def test_group_bitwise_equal_to_the_oracle(name, tdt, jdt, shapes):
    qs, items = group_of(shapes, tdt, seed=3)
    qb.dequantize_blockwise_group_plain(items)
    for (q, s), (_, _, out) in zip(qs, items):
        oracle = ref.dequantize_blockwise(jnp.asarray(q), jnp.asarray(s),
                                          dtype=jdt)
        assert out.shape == q.shape and out.dtype == tdt
        np.testing.assert_array_equal(bits(out), bits(oracle))


def test_group_mixed_output_types_equal_single_calls():
    qs, items = group_of(ANY_SHAPES, torch.float32, seed=5)
    items = [(q, s, out.to(torch.bfloat16) if i % 2 else out)
             for i, (q, s, out) in enumerate(items)]
    qb.dequantize_blockwise_group(items)
    for q, s, out in items:
        single = qb.dequantize_blockwise(q, s, dtype=out.dtype)
        np.testing.assert_array_equal(bits(out), bits(single))


def test_group_cpu_route_is_the_plain_version_and_counts_nothing():
    _, items = group_of(ANY_SHAPES, torch.float32, seed=7)
    _, again = group_of(ANY_SHAPES, torch.float32, seed=7)
    before = launch_counts()["dequantize_blockwise"]
    qb.dequantize_blockwise_group(items)
    qb.dequantize_blockwise_group_plain(again)
    assert launch_counts()["dequantize_blockwise"] == before
    for (_, _, a), (_, _, b) in zip(items, again):
        np.testing.assert_array_equal(bits(a), bits(b))
    qb.dequantize_blockwise_group([])              # nothing to do


def test_group_rejects_bad_items():
    q = torch.zeros((2, 200), dtype=torch.int8)
    s = torch.ones((2, 2))
    with pytest.raises(ValueError, match="do not fit"):
        qb.dequantize_blockwise_group([(q, torch.ones((2, 1)),
                                        torch.empty(2, 200))])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qb.dequantize_blockwise_group([(q, s, torch.empty(
            (2, 200), dtype=torch.float16))])
    with pytest.raises(ValueError, match="does not match"):
        qb.dequantize_blockwise_group([(q, s, torch.empty(2, 100))])
    with pytest.raises(ValueError, match="contiguous"):
        qb.dequantize_blockwise_group([(q, s, torch.empty(200, 2).t())])


# ---------------------------------------------------------------------------
# the q8 gradient wire
# ---------------------------------------------------------------------------

WIRE_SHAPES = {"embed": (64, 256), "final_norm.scale": (256,),
               "layers.0.attn.wq": (256, 4, 64), "layers.0.attn.bias": (4,),
               "layers.0.mlp.wi": (256, 704), "layers.0.mlp.wo": (704, 256),
               "layers.0.norm1.scale": (256,), "odd": (5, 7),
               "ragged": (33, 130), "scalar": ()}


def seeded_grads(seed):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(sh) * 10.0 ** rng.integers(
        -6, 1), dtype=np.float32) for k, sh in WIRE_SHAPES.items()}


def reference_wire(grads):
    """The reference step's q8 wire: its `qdq` mapped over the tree."""
    def qdq(g):
        if g.ndim == 0 or g.shape[-1] < 8:
            return g
        q, s = ref.quantize_blockwise(g)
        return ref.dequantize_blockwise(q, s, dtype=g.dtype)
    return {k: np.asarray(qdq(jnp.asarray(g))) for k, g in grads.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bucket_bytes", [1, 40_000, 1 << 40],
                         ids=["one per bucket", "a few", "one bucket"])
def test_wire_bitwise_equal_to_the_reference_in_place(seed, bucket_bytes,
                                                      monkeypatch):
    monkeypatch.setattr(step, "WIRE_BUCKET_BYTES", bucket_bytes)
    grads_np = seeded_grads(seed)
    grads = {k: torch.from_numpy(g.copy()) for k, g in grads_np.items()}
    storage = {k: g.data_ptr() for k, g in grads.items()}
    step.q8_wire(grads)
    want = reference_wire(grads_np)
    assert list(grads) == list(want)
    for k, g in grads.items():
        assert g.data_ptr() == storage[k]       # in place
        np.testing.assert_array_equal(bits(g), bits(want[k]))


def test_bucket_boundaries_change_no_bit(monkeypatch):
    got = {}
    for bucket_bytes in (1, 20_000, 1 << 40):
        monkeypatch.setattr(step, "WIRE_BUCKET_BYTES", bucket_bytes)
        grads = {k: torch.from_numpy(g) for k, g in seeded_grads(9).items()}
        step.q8_wire(grads)
        got[bucket_bytes] = grads
    for k in WIRE_SHAPES:
        np.testing.assert_array_equal(bits(got[1][k]), bits(got[1 << 40][k]))
        np.testing.assert_array_equal(bits(got[1][k]), bits(got[20_000][k]))


def test_wire_buckets_cut_in_order_at_the_bucket_bytes(monkeypatch):
    tensors = [torch.zeros(sh) for sh in WIRE_SHAPES.values()]
    carried = [i for i, t in enumerate(tensors) if step.on_wire(t)]
    assert [list(WIRE_SHAPES)[i] for i in range(len(tensors))
            if i not in carried] == ["layers.0.attn.bias", "odd", "scalar"]
    monkeypatch.setattr(step, "WIRE_BUCKET_BYTES", 1)
    assert step.wire_buckets(tensors) == [[i] for i in carried]
    monkeypatch.setattr(step, "WIRE_BUCKET_BYTES", 1 << 40)
    assert step.wire_buckets(tensors) == [carried]
    monkeypatch.setattr(step, "WIRE_BUCKET_BYTES", 200_000)
    buckets = step.wire_buckets(tensors)
    assert [i for b in buckets for i in b] == carried
    for b in buckets:
        size = sum(tensors[i].numel() for i in b)
        assert size <= 200_000 or len(b) == 1
    assert len(buckets) == 3
    assert step.WIRE_BUCKET_BYTES == 200_000


def test_wire_bucket_constant_is_256_mib():
    assert step.WIRE_BUCKET_BYTES == 256 << 20


def test_wire_takes_non_contiguous_gradients():
    grads_np = seeded_grads(4)
    grads = {k: torch.from_numpy(g) for k, g in grads_np.items()}
    grads["layers.0.mlp.wo"] = torch.from_numpy(
        np.ascontiguousarray(grads_np["layers.0.mlp.wo"].T)).t()
    assert not grads["layers.0.mlp.wo"].is_contiguous()
    step.q8_wire(grads)
    want = reference_wire(grads_np)
    for k, g in grads.items():
        np.testing.assert_array_equal(bits(g.contiguous()), bits(want[k]))


@pytest.mark.parametrize("shape,limit", [((10, 300), 1000), ((7, 3, 128), 400),
                                         ((5, 64), 1 << 31)])
def test_kernel_table_splits_large_tensors_by_rows(shape, limit, monkeypatch):
    """The kernel takes items of fewer than 2^31 elements; a larger tensor
    becomes one table row per run of whole rows (`_MAX_ITEM` made small)."""
    monkeypatch.setattr(qb, "_MAX_ITEM", limit)
    q = torch.zeros(shape, dtype=torch.int8)
    s = torch.zeros((*shape[:-1], -(-shape[-1] // 128)))
    out = torch.zeros(shape, dtype=torch.bfloat16)
    table = qb._table_rows(q, s, out, 128)
    n, nb = shape[-1], s.shape[-1]
    rows = q.numel() // n
    assert sum(r[3] for r in table) == rows
    assert all(r[3] * n < limit for r in table)
    first = 0
    for qa, sa, oa, r, nn, bf16 in table:
        assert (qa - q.data_ptr(), sa - s.data_ptr(), oa - out.data_ptr()) \
            == (first * n, first * nb * 4, first * n * 2)
        assert nn == n and bf16 == 1
        first += r
