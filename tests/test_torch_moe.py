"""The port's MoE layer and MoE models against the JAX package, on the CPU.

`moe_mlp` and its routing (`moe_routing`: logits, top-k with the lower
expert first on a tie, slot-major capacity positions, keep mask) against
the JAX function's ops on the same weights and tokens, with random
routers, exactly tied logits, padded experts and capacity pressure; its
gradients against `jax.grad`; the reference's slot coupling in a batched
decode (an inactive slot's token changes an active slot's logits through
the experts' shared capacity) reproduced decode for decode; and
`make_train_step` and the `Trainer` on `granite-moe-3b-a800m`'s smoke
configuration against the JAX package's.

Tolerances: routing (expert indices, capacity positions, keep mask)
exact; router logits, gates, outputs and logits within rtol and atol 1e-5
(float32 op for op, different summation orders); gradients within rtol
1e-4 and atol 1e-6; `make_train_step` losses (float32 compute) within
rtol 1e-4; the Trainer (bfloat16 compute) within rtol 2e-2, as
`test_torch_train.py`'s Trainer test (bfloat16 rounds at other places in
the two frameworks).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch import nn

from repro.configs import smoke_config
from repro.data import pipeline as JD
from repro.launch import roofline as JR
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ModelConfig, MoEConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train import loop as JLOOP
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.data import pipeline as TD
from repro_torch.design import advisor as TA
from repro_torch.models import interop
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import loop as TLOOP
from repro_torch.train.step import make_train_step
from torch_port_util import carried_lm, port_model_config

GRANITE = smoke_config("granite-moe-3b-a800m")


def moe_cfg(d=32, **moe):
    kw = dict(n_experts=8, top_k=2, d_ff_expert=16)
    kw.update(moe)
    return ModelConfig("moe", "moe", 1, d, 4, 2, 64, 256, d_head=8,
                       moe=MoEConfig(**kw))


# name, config, tokens (B, S), router override
CASES = [
    ("random", moe_cfg(), (2, 5), None),
    ("zero-router-ties", moe_cfg(), (2, 5), "zero"),
    ("tied-columns", moe_cfg(), (3, 4), "tied"),
    ("padded-experts", moe_cfg(n_experts=6, n_experts_padded=8), (2, 6),
     None),
    ("capacity-pressure", moe_cfg(capacity_factor=0.25), (4, 16), None),
    ("granite-decode", moe_cfg(d=48, n_experts=40, top_k=8), (4, 1), None),
]


def jax_routing(p, xt, moe):
    """The routing lines of the JAX `moe_mlp`."""
    t = xt.shape[0]
    e, k = moe.experts, moe.top_k
    cap = max(int(math.ceil(t * k * moe.capacity_factor / e)), 1)
    logits = xt.astype(jnp.float32) @ p["router"]
    if moe.n_experts_padded and moe.n_experts_padded > moe.n_experts:
        logits = jnp.where((jnp.arange(e) < moe.n_experts)[None, :],
                           logits, JL.NEG_INF)
    gates, idx = lax.top_k(logits, k)
    gates = jax.nn.softmax(gates, axis=-1)
    flat_e = idx.T.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), axis=0) - 1
    flat_pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return logits, gates, idx, flat_pos, flat_pos < cap


def moe_pair(cfg, router):
    p = JL.init_moe(jax.random.PRNGKey(3), cfg)
    if router == "zero":
        p["router"] = jnp.zeros_like(p["router"])
    elif router == "tied":   # experts 2 and 5 tie on top for `inputs` rows
        r = np.array(p["router"])
        r[:, 2] = r[:, 5] = 0.5 * inputs((1, 1), cfg.d_model)[0, 0]
        p["router"] = jnp.asarray(r)
    tp = TL.MoE({k: nn.Parameter(torch.from_numpy(np.array(v)))
                 for k, v in p.items()}, port_model_config(cfg).moe)
    return p, tp


def inputs(shape, d, seed=1, same_rows=False):
    x = np.random.default_rng(seed).standard_normal(shape + (d,)).astype(
        np.float32)
    if same_rows:
        x[:] = x[0, 0]
    return x


@pytest.mark.parametrize("name,cfg,shape,router", CASES,
                         ids=[c[0] for c in CASES])
def test_moe_routing_and_output_match_jax(name, cfg, shape, router):
    p, tp = moe_pair(cfg, router)
    x = inputs(shape, cfg.d_model, same_rows=router == "tied")
    xt = x.reshape(-1, cfg.d_model)
    want = jax_routing(p, jnp.asarray(xt), cfg.moe)
    with torch.no_grad():
        got = TL.moe_routing(tp, torch.from_numpy(xt), tp.moe)
        out = TL.moe_mlp(tp, torch.from_numpy(x), tp.moe)
    logits, gates, idx, flat_pos, keep = (np.asarray(w) for w in want)
    np.testing.assert_allclose(got[0].numpy(), logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), gates, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), idx)
    np.testing.assert_array_equal(got[3].numpy(), flat_pos)
    np.testing.assert_array_equal(got[4].numpy(), keep)
    if router == "zero":     # all tied: the lowest experts, in order
        assert (idx == np.arange(cfg.moe.top_k)).all()
    if router == "tied":     # a tie on top: the lower expert first
        assert (idx == [2, 5]).all()
    if name == "padded-experts":
        assert idx.max() < cfg.moe.n_experts
    if name in ("capacity-pressure", "granite-decode"):
        assert not keep.all()
    np.testing.assert_allclose(
        out.numpy(), np.asarray(JL.moe_mlp(p, jnp.asarray(x), cfg.moe)),
        rtol=1e-5, atol=1e-5)


def test_moe_gradients_match_jax():
    cfg = moe_cfg(capacity_factor=0.5)
    p, tp = moe_pair(cfg, None)
    x = inputs((2, 8), cfg.d_model)
    xs = torch.from_numpy(x).requires_grad_(True)
    out = TL.moe_mlp(tp, xs, tp.moe)
    w = np.random.default_rng(4).standard_normal(out.shape).astype(
        np.float32)
    loss = (out * torch.from_numpy(w)).sum()
    names, ps = zip(*tp.named_parameters())
    grads = torch.autograd.grad(loss, ps + (xs,))
    jg = jax.grad(lambda p_, x_: (JL.moe_mlp(p_, x_, cfg.moe) * w).sum(),
                  argnums=(0, 1))(p, jnp.asarray(x))
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][n]),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg[1]),
                               rtol=1e-4, atol=1e-6)


def test_moe_slot_coupling_reproduces_the_reference():
    """Two slots, slot 1 inactive: changing slot 1's token changes slot 0's
    logits in the same single-step decodes as in the JAX package (the
    capacity counts both slots' tokens)."""
    pc, jp, tp = carried_lm(GRANITE)
    jdec = jax.jit(lambda p, s, t, a: JM.decode_step(p, s, GRANITE, t, a))
    active = np.array([True, False])
    rng = np.random.default_rng(0)
    changed = {"jax": [], "port": []}
    for _ in range(40):
        t0, a, b = rng.integers(0, GRANITE.vocab, 3)
        outs = {"jax": [], "port": []}
        for other in (a, b):
            toks = np.array([[t0], [other]], np.int32)
            jl, _ = jdec(jp, JM.init_serve_state(GRANITE, 2, 8, jnp.float32),
                         jnp.asarray(toks), jnp.asarray(active))
            tl, _ = TM.decode_step(
                tp, TM.init_serve_state(pc, 2, 8, torch.float32,
                                        device="cpu"),
                pc, torch.from_numpy(toks), torch.from_numpy(active))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5)
            outs["jax"].append(np.asarray(jl)[0, 0])
            outs["port"].append(tl.numpy()[0, 0])
        for k, (la, lb) in outs.items():
            changed[k].append(bool((la != lb).any()))
    print(f"slot 0's logits changed with slot 1's token in "
          f"{sum(changed['port'])} of 40 decodes (JAX: "
          f"{sum(changed['jax'])})")
    assert changed["port"] == changed["jax"]
    assert sum(changed["jax"]) > 0


def test_moe_train_step_matches_jax():
    lr = 1e-2
    pc, jp, tp = carried_lm(GRANITE)
    jopt, topt = JAdamWConfig(lr=lr), AdamWConfig(lr=lr)
    jstate = j_adamw_init(jp, jopt)
    tstate = adamw_init(tp, topt)
    jstep = jax.jit(j_make_train_step(GRANITE, jopt, compute_dtype=None,
                                      attn_impl="full"))
    tstep = make_train_step(pc, topt, compute_dtype=None, attn_impl="full")
    jd = JD.DataConfig(vocab=GRANITE.vocab, batch=4, seq=16, seed=2)
    td = TD.DataConfig(vocab=GRANITE.vocab, batch=4, seq=16, seed=2)
    for s in range(3):
        jp, jstate, jloss = jstep(jp, jstate, JD.batch_at(jd, s))
        tp, tstate, tloss = tstep(tp, tstate, TD.batch_at(td, s, "cpu"))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert float(tloss) < 5.55


def test_moe_trainer_matches_jax_trainer(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(TA, name, getattr(JR, name))
    kw = dict(steps=3, batch=4, seq=32, lr=1e-2, hbm_budget_bytes=1e5,
              log_every=1000)
    jt = JLOOP.Trainer(GRANITE, JLOOP.TrainConfig(checkpoint_dir=None, **kw))
    pc = port_model_config(GRANITE)
    tt = TLOOP.Trainer(pc, TLOOP.TrainConfig(**kw), device="cpu")
    assert tt.plan.choices == jt.plan.choices
    assert tt.opt_cfg.state_codec == jt.opt_cfg.state_codec == "q8"
    tt.params = interop.params_from_numpy(jax.tree.map(np.asarray,
                                                       jt.params), pc, "cpu")
    tt.opt_state = interop.opt_state_from_numpy(
        jax.tree.map(np.asarray, jt.opt_state), tt.params, "cpu")
    jt.run()
    tt.run()
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=2e-2)
