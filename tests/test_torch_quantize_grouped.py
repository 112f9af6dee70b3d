"""The port's grouped blockwise quantization, and the q8 gradient wire and
q8 AdamW moments that run through it, against the JAX package, on the CPU.

On CPU tensors `quantize_blockwise_group` runs its plain version, one
`quantize_blockwise_plain` per item written into the item's q and scales.
The JAX side runs its jnp oracle `ref.quantize_blockwise` and its Pallas
kernel `quantize_blockwise_2d` in interpret mode, per tensor, on the same
NumPy data made from a seed.  The oracle divides like the port (one IEEE
division for the scale, one per element, round half to even), so q and
the scales agree BITWISE.  The Pallas kernel is held to
`tests/test_kernels.py`'s tolerances (|dq| <= 1 at <= 0.1 % of positions,
scales rtol 1e-5): it may multiply by a rounded reciprocal of 127.

The wire: the reference maps quantize-then-dequantize over the gradient
tree (`repro/train/step.py`, its `qdq`); the port quantizes a bucket of
gradients in one grouped call and dequantizes it in another.  Its q8
format and its result equal the reference's, whatever the buckets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.quantize_blockwise import quantize_blockwise_2d
from repro_torch.kernels import launch_counts
from repro_torch.kernels import quantize_blockwise as qb
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train import step

DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]
# 2-D shapes the Pallas kernel's tiling takes (rows <= 256 or a multiple;
# columns <= 512 and a multiple of the block, or a multiple of 512)
PALLAS_SHAPES = [(8, 128), (16, 256), (4, 512), (2, 1024), (256, 384)]
# any rank, ragged last blocks, last dimensions under one block (n < 4
# included), one-element rows
ANY_SHAPES = [(2048,), (300,), (7,), (3,), (1,), (32, 64), (9, 130),
              (3, 5, 200), (2, 3, 4, 384), (2, 2, 2, 129), (6, 1), (5, 5)]


def seeded(shape, seed):
    """NumPy float32 data with an all-zero block and a block of equal
    magnitudes where the shape has room for them."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(
        np.float32)
    if shape[-1] > 256:
        x[..., :128] = 0.0
        x[..., 128:256] = np.where(x[..., 128:256] < 0, -2.5, 2.5)
    return x


def items_of(xs, tdt, block=qb.DEFAULT_BLOCK):
    """Torch (x, q, scales) items for NumPy inputs; q starts at 99 and the
    scales as NaN, so an element left unwritten shows."""
    items = []
    for x in xs:
        nb = -(-x.shape[-1] // block)
        items.append((torch.from_numpy(x).to(tdt),
                      torch.full(x.shape, 99, dtype=torch.int8),
                      torch.full((*x.shape[:-1], nb), float("nan"))))
    return items


def scale_bits(s):
    return np.asarray(s, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
@pytest.mark.parametrize("shapes", [ANY_SHAPES, PALLAS_SHAPES + ANY_SHAPES],
                         ids=["any rank", "mixed"])
def test_group_bitwise_equal_to_single_plain_calls(name, tdt, jdt, plain,
                                                   shapes):
    xs = [seeded(sh, i) for i, sh in enumerate(shapes)]
    items = items_of(xs, tdt)
    group = qb.quantize_blockwise_group_plain if plain else \
        qb.quantize_blockwise_group
    group(items)
    for x, q, s in items:
        q1, s1 = qb.quantize_blockwise_plain(x)
        assert torch.equal(q, q1)
        np.testing.assert_array_equal(scale_bits(s), scale_bits(s1))


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("shapes", [ANY_SHAPES, PALLAS_SHAPES],
                         ids=["any rank", "pallas shapes"])
def test_group_bitwise_equal_to_the_oracle(name, tdt, jdt, shapes):
    xs = [seeded(sh, 10 + i) for i, sh in enumerate(shapes)]
    items = items_of(xs, tdt)
    qb.quantize_blockwise_group(items)
    for x, (_, q, s) in zip(xs, items):
        q_r, s_r = ref.quantize_blockwise(jnp.asarray(x).astype(jdt))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
        np.testing.assert_array_equal(scale_bits(s), scale_bits(s_r))


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_group_close_to_the_pallas_kernel(name, tdt, jdt):
    xs = [seeded(sh, 20 + i) for i, sh in enumerate(PALLAS_SHAPES)]
    items = items_of(xs, tdt)
    qb.quantize_blockwise_group(items)
    for x, (_, q, s) in zip(xs, items):
        q_k, s_k = quantize_blockwise_2d(jnp.asarray(x).astype(jdt),
                                         interpret=True)
        dq = np.abs(q.numpy().astype(np.int32) - np.asarray(q_k, np.int32))
        assert dq.max() <= 1 and (dq != 0).mean() <= 1e-3
        np.testing.assert_allclose(s.numpy(), np.asarray(s_k), rtol=1e-5)


@pytest.mark.parametrize("block", [1, 6, 64, 100, 256])
def test_group_at_other_blocks_equals_single_plain_calls(block):
    """Blocks under 4, off a multiple of 4, under and above 128 (the
    kernel's two-pass path), each against single plain calls and the
    oracle."""
    xs = [seeded(sh, block + i) for i, sh in enumerate(
        [(3, 300), (7,), (4, 2, 129), (1, 1000)])]
    items = items_of(xs, torch.float32, block)
    qb.quantize_blockwise_group(items, block)
    for x, q, s in items:
        q1, s1 = qb.quantize_blockwise_plain(x, block)
        assert torch.equal(q, q1) and torch.equal(s, s1)
        q_r, s_r = ref.quantize_blockwise(jnp.asarray(x.numpy()), block)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))


def test_group_rounds_half_to_even_at_the_int8_boundaries():
    # absmax 127 gives scale 1, so x / scale lands exactly on .5 values,
    # up to +-126.5 and the clip at +-127
    x = np.zeros((2, 128), np.float32)
    x[0, 0] = 127.0
    x[0, 1:11] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.0,
                  -127.0]
    x[1, :3] = [-127.0, 126.49999, 63.5]
    items = items_of([x], torch.float32)
    qb.quantize_blockwise_group(items)
    q = items[0][1]
    assert q[0, 1:11].tolist() == [0, 2, 2, 0, -2, -2, 126, -126, 127, -127]
    assert q[1, :3].tolist() == [-127, 126, 64]
    q_r, _ = ref.quantize_blockwise(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))


def test_single_call_is_a_one_item_group():
    for i, sh in enumerate(ANY_SHAPES):
        x = torch.from_numpy(seeded(sh, 30 + i))
        items = items_of([x.numpy()], torch.float32)
        qb.quantize_blockwise_group(items)
        q, s = qb.quantize_blockwise(x)
        assert torch.equal(q, items[0][1]) and torch.equal(s, items[0][2])


def test_group_takes_empty_tensors_and_empty_lists():
    shapes = [(0, 5), (3, 0), (0,), (4, 130)]
    xs = [seeded(sh, 40) if 0 not in sh else np.zeros(sh, np.float32)
          for sh in shapes]
    items = items_of(xs, torch.float32)
    qb.quantize_blockwise_group(items)
    for x, q, s in items:
        q1, s1 = qb.quantize_blockwise_plain(x)
        assert q.shape == q1.shape and s.shape == s1.shape
        assert torch.equal(q, q1) and torch.equal(s, s1)
    qb.quantize_blockwise_group([])
    qb.quantize_blockwise_group_plain([])


def test_group_takes_non_contiguous_inputs():
    x = seeded((130, 9), 50)
    items = items_of([np.ascontiguousarray(x.T)], torch.float32)
    xt = torch.from_numpy(x).t()
    assert not xt.is_contiguous()
    q, s = items[0][1], items[0][2]
    qb.quantize_blockwise_group([(xt, q, s)])
    q1, s1 = qb.quantize_blockwise_plain(xt.contiguous())
    assert torch.equal(q, q1) and torch.equal(s, s1)


def test_group_cpu_route_is_the_plain_version_and_counts_nothing():
    xs = [seeded(sh, 60 + i) for i, sh in enumerate(ANY_SHAPES)]
    items, again = items_of(xs, torch.float32), items_of(xs, torch.float32)
    before = launch_counts()["quantize_blockwise"]
    qb.quantize_blockwise_group(items)
    qb.quantize_blockwise_group_plain(again)
    assert launch_counts()["quantize_blockwise"] == before
    for (_, q, s), (_, q2, s2) in zip(items, again):
        assert torch.equal(q, q2) and torch.equal(s, s2)


def test_group_rejects_bad_items():
    x = torch.zeros((2, 200))
    q = torch.zeros((2, 200), dtype=torch.int8)
    s = torch.zeros((2, 2))
    bad = [
        ((x.to(torch.float16), q, s), "float32 or bfloat16"),
        ((x.to(torch.int64), q, s), "float32 or bfloat16"),
        ((torch.zeros(()), torch.zeros((), dtype=torch.int8),
          torch.zeros((1,))), "last dimension"),
        ((x, q.to(torch.int16), s), "int8"),
        ((x, torch.zeros((2, 100), dtype=torch.int8), s), "int8 of x's"),
        ((x, q, torch.zeros((2, 1))), "do not fit"),
        ((x, q, s.to(torch.float64)), "do not fit"),
        ((x, torch.zeros((200, 2), dtype=torch.int8).t(), s), "contiguous"),
        ((x, q, torch.zeros((2, 2)).t()), "contiguous"),
    ]
    for item, match in bad:
        with pytest.raises(ValueError, match=match):
            qb.quantize_blockwise_group([item])
        with pytest.raises(ValueError, match=match):
            qb.quantize_blockwise_group_plain([item])
    with pytest.raises(ValueError, match="block >= 1"):
        qb.quantize_blockwise_group([(x, q, s)], block=0)


@pytest.mark.parametrize("shape,dtype,limit", [
    ((10, 300), torch.float32, 1000), ((7, 3, 128), torch.bfloat16, 400),
    ((5, 64), torch.float32, 1 << 31), ((9, 5), torch.bfloat16, 6)])
def test_quantize_table_splits_large_tensors_by_rows(shape, dtype, limit,
                                                     monkeypatch):
    """The kernel takes items of fewer than 2^31 elements; a larger tensor
    becomes one table row per run of whole rows (`_MAX_ITEM` made small)."""
    monkeypatch.setattr(qb, "_MAX_ITEM", limit)
    x = torch.zeros(shape, dtype=dtype)
    q = torch.zeros(shape, dtype=torch.int8)
    s = torch.zeros((*shape[:-1], -(-shape[-1] // 128)))
    table = qb._quantize_rows(x, q, s, 128)
    n, nb, es = shape[-1], s.shape[-1], x.element_size()
    rows = x.numel() // n
    assert sum(r[3] for r in table) == rows
    assert all(r[3] * n < limit for r in table)
    first = 0
    for xa, qa, sa, r, nn, bf16 in table:
        assert (xa - x.data_ptr(), qa - q.data_ptr(), sa - s.data_ptr()) \
            == (first * n * es, first * n, first * nb * 4)
        assert nn == n and bf16 == int(dtype == torch.bfloat16)
        first += r


def test_row_runs_reject_a_last_dimension_of_2_31():
    with pytest.raises(ValueError, match="last dimension"):
        qb._row_runs(2 ** 31, 1)
    assert qb._row_runs(3, 0) == []


# ---------------------------------------------------------------------------
# the q8 gradient wire and the q8 AdamW moments
# ---------------------------------------------------------------------------

WIRE_SHAPES = {"embed": (64, 256), "final_norm.scale": (256,),
               "layers.0.attn.wq": (256, 4, 64), "layers.0.attn.bias": (4,),
               "layers.0.mlp.wi": (256, 704), "layers.0.mlp.wo": (704, 256),
               "layers.0.norm1.scale": (256,), "odd": (5, 7),
               "ragged": (33, 130), "narrow": (40, 8), "scalar": ()}


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
    grads_np = seeded_grads(seed + 100)
    grads = {k: torch.from_numpy(g.copy()) for k, g in grads_np.items()}
    storage = {k: g.data_ptr() for k, g in grads.items()}
    step.q8_wire(grads)
    want = reference_wire(grads_np)
    assert list(grads) == list(want)
    for k, g in grads.items():
        assert g.data_ptr() == storage[k]       # in place
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      want[k].view(np.int32))


@pytest.mark.parametrize("bucket_bytes", [1, 40_000, 1 << 40],
                         ids=["one per bucket", "a few", "one bucket"])
def test_wire_quantizes_each_bucket_in_one_group_into_the_reference_format(
        bucket_bytes, monkeypatch):
    """One grouped quantize call per bucket, over exactly the bucket's
    gradients in order; its q8 values and scales are the reference's."""
    monkeypatch.setattr(step, "WIRE_BUCKET_BYTES", bucket_bytes)
    calls = []
    real = step.quantize_blockwise_group

    def recording(items, *a, **kw):
        real(items, *a, **kw)
        calls.append([(x.clone(), q.clone(), s.clone()) for x, q, s in items])
    monkeypatch.setattr(step, "quantize_blockwise_group", recording)
    grads_np = seeded_grads(7)
    grads = {k: torch.from_numpy(g.copy()) for k, g in grads_np.items()}
    buckets = step.wire_buckets(list(grads.values()))
    step.q8_wire(grads)
    names = list(grads)
    assert [len(c) for c in calls] == [len(b) for b in buckets]
    for bucket, call in zip(buckets, calls):
        for i, (x, q, s) in zip(bucket, call):
            g = grads_np[names[i]]
            np.testing.assert_array_equal(x.numpy(), g)
            q_r, s_r = ref.quantize_blockwise(jnp.asarray(g))
            np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
            np.testing.assert_array_equal(scale_bits(s), scale_bits(s_r))


def reference_q8_update(p, g, mom, cfg, step_no):
    """The q8 AdamW update of one parameter with single quantize and
    dequantize calls (the port's earlier form of `upd_q8`)."""
    t = torch.tensor(step_no, dtype=torch.float32)
    bc1, bc2 = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
    m = qb.dequantize_blockwise(mom["m_q"], mom["m_s"])
    v_sqrt = qb.dequantize_blockwise(mom["v_q"], mom["v_s"])
    v = v_sqrt * v_sqrt
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    new_p = p - cfg.lr * (update + cfg.weight_decay * p)
    m_q, m_s = qb.quantize_blockwise(m)
    v_q, v_s = qb.quantize_blockwise(torch.sqrt(v))
    return new_p, {"m_q": m_q, "m_s": m_s, "v_q": v_q, "v_s": v_s}


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_q8_moments_go_in_two_item_groups_and_equal_single_calls(
        steps, monkeypatch):
    """Per parameter and step: one grouped dequantize of (m, sqrt v) and
    one grouped quantize of the new pair, with the bits of single calls."""
    rng = np.random.default_rng(steps)
    shapes = {"w": (16, 200), "b": (130,), "n": (3, 4, 8)}
    params = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(sh).astype(np.float32))) for k, sh in
        shapes.items()})
    cfg = AdamWConfig(lr=1e-2, state_codec="q8")
    state = adamw.adamw_init(params, cfg)
    want_p = {k: p.detach().clone() for k, p in params.items()}
    want_m = {k: dict(m) for k, m in state["moments"].items()}
    sizes = {"q": [], "dq": []}
    real_q, real_dq = adamw.quantize_blockwise_group, \
        adamw.dequantize_blockwise_group
    monkeypatch.setattr(adamw, "quantize_blockwise_group", lambda items: (
        sizes["q"].append(len(items)), real_q(items))[1])
    monkeypatch.setattr(adamw, "dequantize_blockwise_group", lambda items: (
        sizes["dq"].append(len(items)), real_dq(items))[1])
    for i in range(steps):
        grads = {k: torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)) for k, sh in shapes.items()}
        adamw.adamw_update(params, grads, state, cfg)
        for k in shapes:
            want_p[k], want_m[k] = reference_q8_update(
                want_p[k], grads[k], want_m[k], cfg, i + 1)
    assert sizes == {"q": [2] * (3 * steps), "dq": [2] * (3 * steps)}
    for k, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy().view(np.int32),
                                      want_p[k].numpy().view(np.int32))
        for name, t in state["moments"][k].items():
            assert torch.equal(t, want_m[k][name]), (k, name)
