"""Training the RWKV6 family in the port against the JAX package, on the
CPU: `make_train_step` and the `Trainer` on the RWKV6 smoke configuration
(the Jamba hybrid's step is in `test_torch_train_hybrid.py`).

Besides, the scan's backward pass: `layers.chunked_scan` reads each step
through one `unbind` an input, so its backward pass writes each input's
gradient once; indexing a step (as before) wrote a zero tensor of the
whole chunk for every step, S^2 work that made the Mamba block's backward
at Jamba's width ten times slower.

The step is the one the card runs in `chip_smoke.py` phase 10c: the q8
gradient wire, q8 AdamW moments, float32 compute and per-layer remat, at
a sequence of two WKV chunks of 256, so the recurrent carry crosses a
checkpointed chunk, and the wire carries partial q8 blocks (last
dimensions 8, 16, 64 and 160: the smoke's LoRAs, heads and token-shift
mixes).  The weights are the JAX `init_params`' carried into the port
(`torch_port_util.carried_lm`); the batches are `batch_at`'s, the same in
both packages.

Tolerances are `test_torch_train.py`'s: losses within rtol 1e-4 and
parameters within 6 lr everywhere and within atol 1e-5 on >= 99.9 % of
elements (the q8 wire can quantize a boundary value one level apart, and
Adam's first updates carry it); the Trainer (bfloat16 compute) within
rtol 2e-2, as `test_torch_moe.py::test_moe_trainer_matches_jax_trainer`.
"""
import jax
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro.configs import smoke_config
from repro.data import pipeline as JD
from repro.launch import roofline as JR
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train import loop as JLOOP
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.data import pipeline as TD
from repro_torch.design import advisor as TA
from repro_torch.models import interop
from repro_torch.models.layers import chunked_scan
from repro_torch.optim import AdamWConfig
from repro_torch.train import loop as TLOOP
from repro_torch.train.step import make_train_step
from torch_port_util import carried_lm, port_model_config

LR = 1e-3


def recurrent_step_matches_jax(arch, seq, batch=1):
    """Three steps with the q8 wire and q8 moments, float32 compute,
    remat, from the JAX package's weights and state, held to the jitted
    JAX step: losses within rtol 1e-4 and falling, parameters within 6 lr
    everywhere and 1e-5 on >= 99.9 %."""
    cfg = smoke_config(arch)
    pc, jp, tp = carried_lm(cfg)
    jopt = JAdamWConfig(lr=LR, state_codec="q8")
    topt = AdamWConfig(lr=LR, state_codec="q8")
    jstate = j_adamw_init(jp, jopt)
    tstate = interop.opt_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          tp, "cpu")
    jstep = jax.jit(j_make_train_step(cfg, jopt, remat=True,
                                      grad_compression="q8",
                                      compute_dtype=None))
    tstep = make_train_step(pc, topt, remat=True, grad_compression="q8",
                            compute_dtype=None)
    jd = JD.DataConfig(vocab=cfg.vocab, batch=batch, seq=seq, seed=1)
    td = TD.DataConfig(vocab=cfg.vocab, batch=batch, seq=seq, seed=1)
    losses = []
    for s in range(3):
        jp, jstate, jloss = jstep(jp, jstate, JD.batch_at(jd, s))
        tp, tstate, tloss = tstep(tp, tstate, TD.batch_at(td, s, "cpu"))
        losses.append((float(tloss), float(jloss)))
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert losses[-1][0] < losses[0][0]
    d = jax.tree.leaves(jax.tree.map(
        lambda got, want: np.abs(got - np.asarray(want)),
        interop.params_to_numpy(tp), jp))
    assert max(a.max() for a in d) <= 6 * LR
    far = sum(int((a > 1e-5).sum()) for a in d)
    total = sum(a.size for a in d)
    print(f"{arch}: params beyond atol 1e-5: {far} of {total}")
    assert far <= 1e-3 * total


def test_rwkv_train_step_matches_jax():
    recurrent_step_matches_jax("rwkv6-7b", 512)


def test_rwkv_trainer_matches_jax_trainer(monkeypatch):
    """The Trainer on the RWKV6 smoke configuration (bfloat16 compute, the
    plan's q8 wire and moments at a small budget) against the JAX
    Trainer, the JAX package's roofline constants patched in."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(TA, name, getattr(JR, name))
    cfg = smoke_config("rwkv6-7b")
    kw = dict(steps=3, batch=2, seq=32, lr=1e-2, hbm_budget_bytes=1e5,
              log_every=1000)
    jt = JLOOP.Trainer(cfg, JLOOP.TrainConfig(checkpoint_dir=None, **kw))
    pc = port_model_config(cfg)
    tt = TLOOP.Trainer(pc, TLOOP.TrainConfig(**kw), device="cpu")
    assert tt.plan.choices == jt.plan.choices
    assert tt.opt_cfg.state_codec == jt.opt_cfg.state_codec == "q8"
    assert tt.grad_compression == "q8"
    tt.params = interop.params_from_numpy(jax.tree.map(np.asarray,
                                                       jt.params), pc, "cpu")
    tt.opt_state = interop.opt_state_from_numpy(
        jax.tree.map(np.asarray, jt.opt_state), tt.params, "cpu")
    jt.run()
    tt.run()
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=2e-2)
    assert tt.history[-1]["loss"] < tt.history[0]["loss"]


def test_chunked_scan_backward_writes_each_gradient_once():
    """Under autograd, 64 steps in checkpointed chunks of 16: no per-step
    index backward (each would write a zero tensor of its whole chunk), and
    the gradients equal those of a loop that indexes each step."""
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(64, 3, 5, generator=gen, requires_grad=True)
          for _ in range(2)]

    def step(c, x):
        c = c * x[0] + x[1]
        return c, c.sum(-1)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        carry, ys = chunked_scan(step, torch.zeros(3, 5), xs, chunk=16)
        (carry.sum() + (ys * ys).sum()).backward()
    names = [e.name for e in prof.events()]
    assert names.count("aten::select_backward") == 0
    assert names.count("aten::unbind") >= 2 * 64 // 16
    got = [x.grad.clone() for x in xs]
    for x in xs:
        x.grad = None
    c, out = torch.zeros(3, 5), []
    for t in range(64):
        c, y = step(c, (xs[0][t], xs[1][t]))
        out.append(y)
    (c.sum() + (torch.stack(out) ** 2).sum()).backward()
    for g, x in zip(got, xs):
        torch.testing.assert_close(g, x.grad, rtol=0, atol=0)
