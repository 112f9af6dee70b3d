"""The port's RWKV6 block, `chunked_scan` and RWKV serving against the
JAX package, on the CPU.

`_group_norm` (the population variance: an unbiased one is shown to miss
JAX's by far more than the tolerance at head size 16), the time and
channel mixes from carried-in state, `chunked_scan` against the JAX
function and against the port's own plain loop, and the serving engine on
`tests/test_serve_engine.py`'s TINY_RWKV: the reference's mid-flight
invariant for recurrent state and the JAX engine's tokens.  Weights come
from the JAX package's init functions, carried over as NumPy arrays.

Tolerances: the group norm, the mixes and their state within rtol and
atol 1e-5 (the WKV scan accumulates in float32 in the same order); the
scan against JAX within rtol and atol 1e-6; the checkpointed scan and its
gradients bitwise equal to the plain loop's; decode step by step against
`forward` within atol 1e-5; engine tokens exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import rwkv as JR
from repro.models.config import ModelConfig, RWKVConfig
from repro.serve import engine as JE
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import rwkv as TR
from repro_torch.serve import engine as TE
from torch_port_util import carried_lm, midflight_tokens

TINY_RWKV = ModelConfig("tiny-rwkv", "ssm", 2, 64, 4, 4, 128, 256,
                        d_head=16, mixer="rwkv6",
                        rwkv=RWKVConfig(head_size=16))


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def test_group_norm_uses_the_population_variance():
    y = normal((2, 3, 4, 16), 0) + 0.3
    scale = normal((64,), 1)
    want = np.asarray(JR._group_norm(jnp.asarray(y), jnp.asarray(scale),
                                     1e-5))
    got = TR._group_norm(torch.from_numpy(y), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the same formula with torch.var's default (unbiased) variance
    t = torch.from_numpy(y)
    unbiased = ((t - t.mean(-1, keepdim=True))
                * torch.rsqrt(t.var(-1, keepdim=True) + 1e-5)
                ).reshape(2, 3, 64) * torch.from_numpy(scale)
    assert np.abs(unbiased.numpy() - want).max() > 100 * 1e-5


@pytest.fixture(scope="module")
def block():
    cfg = TINY_RWKV
    pc, jp, tp = carried_lm(cfg, seed=2)
    return cfg, pc, jax.tree.map(lambda a: a[0], jp["layers"]["rwkv"]), \
        tp.layers[0]["rwkv"]


def test_time_and_channel_mix_match_jax_from_carried_state(block):
    cfg, pc, jblk, tblk = block
    b, s, d = 3, 7, cfg.d_model
    nh, hs = d // 16, 16
    x = normal((b, s, d), 3)
    shift = normal((b, d), 4)
    wkv = normal((b, nh, hs, hs), 5, 0.1)
    want = JR.time_mix_sequence(jblk["tm"], jnp.asarray(x), cfg,
                                jnp.asarray(shift), jnp.asarray(wkv))
    got = TR.time_mix_sequence(tblk["tm"], torch.from_numpy(x), pc,
                               torch.from_numpy(shift),
                               torch.from_numpy(wkv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    # the new shift is the (normed) input's last token
    assert torch.equal(got[1], torch.from_numpy(x[:, -1]))
    want = JR.channel_mix_sequence(jblk["cm"], jnp.asarray(x),
                                   jnp.asarray(shift))
    got = TR.channel_mix_sequence(tblk["cm"], torch.from_numpy(x),
                                  torch.from_numpy(shift))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def scan_inputs(s):
    return normal((4, 3), 6), (normal((s, 4, 3), 7), normal((s, 4, 3), 8))


def t_step(c, xs):
    a, b = xs
    c = torch.tanh(c * a + b)
    return c, c * 2.0


def j_step(c, xs):
    a, b = xs
    c = jnp.tanh(c * a + b)
    return c, c * 2.0


@pytest.mark.parametrize("s,chunk", [(12, 4), (10, 4), (5, 16), (1, 128)])
def test_chunked_scan_matches_jax_and_the_plain_loop(s, chunk):
    c0, xs = scan_inputs(s)
    want_c, want_y = JL.chunked_scan(j_step, jnp.asarray(c0),
                                     tuple(map(jnp.asarray, xs)), chunk)
    leaves = [torch.from_numpy(c0).requires_grad_(True)] + \
        [torch.from_numpy(a).requires_grad_(True) for a in xs]
    runs = {}
    for mode in ("chunked", "plain"):
        with torch.set_grad_enabled(True):
            c, y = (TL.chunked_scan if mode == "chunked" else TL._scan)(
                t_step, leaves[0], tuple(leaves[1:]),
                *((chunk,) if mode == "chunked" else ()))
            grads = torch.autograd.grad((c.sum() + (y * y).sum()), leaves)
        runs[mode] = (c.detach(), y.detach(), grads)
    np.testing.assert_allclose(runs["chunked"][0].numpy(),
                               np.asarray(want_c), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(runs["chunked"][1].numpy(),
                               np.asarray(want_y), rtol=1e-6, atol=1e-6)
    for a, b in zip(runs["chunked"][:2] + runs["chunked"][2],
                    runs["plain"][:2] + runs["plain"][2]):
        assert torch.equal(a, b)


def test_chunked_scan_checkpoints_only_under_grad(monkeypatch):
    calls = []
    monkeypatch.setattr(TL, "checkpoint",
                        lambda fn, *a, **kw: calls.append(1) or fn(*a))
    c0, xs = scan_inputs(8)
    args = (t_step, torch.from_numpy(c0), tuple(map(torch.from_numpy, xs)))
    with torch.no_grad():
        TL.chunked_scan(*args, 4)
    assert calls == []
    with torch.enable_grad():
        TL.chunked_scan(*args, 4)
    assert len(calls) == 2


@pytest.fixture(scope="module")
def model():
    return carried_lm(TINY_RWKV, seed=1)


def test_decode_one_token_at_a_time_equals_forward(model):
    pc, _, tp = model
    toks = np.random.default_rng(9).integers(0, 256, (2, 9)).astype(np.int32)
    with torch.no_grad():
        full = TM.forward(tp, pc, torch.from_numpy(toks))
    state = TM.init_serve_state(pc, 2, 16, device="cpu")
    assert "kv" not in state
    assert state["rwkv"]["wkv"].shape == (2, 2, 4, 16, 16)
    for i in range(toks.shape[1]):
        logits, state = TM.decode_step(tp, state, pc,
                                       torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=0, atol=1e-5)


def test_inactive_slots_keep_their_recurrent_state(model):
    pc, _, tp = model
    state = TM.init_serve_state(pc, 3, 8, device="cpu")
    for step in range(3):
        toks = torch.tensor([[5 + step], [7], [9]], dtype=torch.int32)
        _, state = TM.decode_step(tp, state, pc, toks)
    before = {k: v.clone() for k, v in state["rwkv"].items()}
    active = torch.tensor([True, False, True])
    _, after = TM.decode_step(tp, state, pc,
                              torch.tensor([[1], [2], [3]],
                                           dtype=torch.int32), active)
    for k in before:
        assert torch.equal(after["rwkv"][k][:, 1], before[k][:, 1])
        assert not torch.equal(after["rwkv"][k][:, 0], before[k][:, 0])
        # the old state's tensors are not written
        assert torch.equal(state["rwkv"][k], before[k])
    reset = TM.reset_slot(after, pc, 2)
    for k in before:
        assert not reset["rwkv"][k][:, 2].any()
        assert torch.equal(reset["rwkv"][k][:, :2], after["rwkv"][k][:, :2])


def test_midflight_admission_parity_recurrent(model):
    """`tests/test_serve_engine.py`'s recurrent invariant on the port:
    inactive slots' RWKV state must not integrate the pad token."""
    pc, jp, tp = model
    alone = midflight_tokens(TE, tp, pc, False, device="cpu")
    assert alone == midflight_tokens(TE, tp, pc, True, device="cpu")
    assert alone == midflight_tokens(JE, jp, TINY_RWKV, True)


def test_slot_reuse_tokens_equal_the_jax_engine(model):
    pc, jp, tp = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, rng.integers(1, 7)).tolist()
               for _ in range(6)]

    def serve(eng, make):
        for uid, p in enumerate(prompts):
            eng.submit(make(uid=uid, prompt=list(p), max_new_tokens=4))
            eng.step()
        eng.run_until_drained()
        return {u: r.out_tokens for u, r in eng.finished.items()}

    want = serve(JE.ServeEngine(TINY_RWKV, jp, JE.EngineConfig(
        batch_slots=2, max_len=32)), JE.Request)
    got = serve(TE.ServeEngine(pc, tp, TE.EngineConfig(
        batch_slots=2, max_len=32), device="cpu"), TE.Request)
    assert got == want
