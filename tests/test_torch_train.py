"""The port's training slice against the JAX package, on the CPU: the data
pipeline, chunked attention, the loss and its gradients, AdamW with float32
and q8 moments, `make_train_step` with the q8 gradient wire, and the
`Trainer`.

Parameters come from the JAX package's `init_params` and optimizer states
from its `adamw_init`, carried into the port with
`repro_torch.models.interop`; tokens, activations and gradients are made
with NumPy from a seed.  The JAX side is the unsharded `make_train_step`.

Tolerances (float32 on both sides unless stated; different summation
orders and one-ulp differences of `pow` in the bias corrections):
* batches equal; chunked attention within atol 1e-5 of JAX and of the
  port's full attention; loss within rtol 1e-5; every gradient leaf
  within 1e-4 * max|g| of `jax.grad`'s; remat on and off bitwise equal in
  the port;
* AdamW after 3 updates from identical params, grads and state: float32
  moments within rtol 1e-6 and params within atol 1e-7; q8 scales within
  rtol 1e-6 and int8 moments equal but for <= 0.01 % of elements one
  level apart (a value an ulp from a rounding boundary);
* three `make_train_step` steps with the q8 wire: float32 compute, loss
  within rtol 1e-4 and params within atol 1e-5 on >= 99.9 % of elements
  and within 6 lr everywhere (see `test_train_step_matches_jax`); bf16
  compute, loss within rtol 2e-2 (bf16 rounds at other places in the two
  frameworks);
* the Trainer (bf16 compute) against the JAX Trainer: the same plan and
  state codec, losses within rtol 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JD
from repro.launch import roofline as JR
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ModelConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.train import loop as JLOOP
from repro.train.step import make_prefill_step as j_make_prefill_step
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.data import pipeline as TD
from repro_torch.design import advisor as TA
from repro_torch.models import interop
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as PortModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train import loop as TLOOP
from repro_torch.train.step import (make_decode_step, make_loss_and_grads,
                                    make_prefill_step, make_train_step)

TINY = ModelConfig("tiny", "dense", 2, 64, 4, 2, 128, 256, d_head=16)
# last dimensions off the 128-element quantization block: ragged blocks
ODD = ModelConfig("odd", "dense", 2, 96, 4, 2, 200, 300, d_head=24)
CONFIGS = [TINY, ODD]
IDS = [c.name for c in CONFIGS]


def port_cfg(cfg):
    return PortModelConfig(**dataclasses.asdict(cfg))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_params(cfg):
    return JM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)


def carry(jp, cfg):
    return interop.params_from_numpy(to_numpy(jp), port_cfg(cfg),
                                     device="cpu")


def named(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def jax_leaf(tree, name):
    """A JAX tree's leaf for a port name ("layers.1.attn.wq.m"), one layer
    of it."""
    parts = name.split(".")
    if parts[0] != "layers":
        for key in parts:
            tree = tree[key]
        return np.asarray(tree)
    tree = tree["layers"]
    for key in parts[2:]:
        tree = tree[key]
    return np.asarray(tree)[int(parts[1])]


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_params_round_trip_through_numpy(cfg):
    tree = to_numpy(jax_params(cfg))
    back = interop.params_to_numpy(carry(tree, cfg))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_batch_at_equals_jax(seed):
    for vocab, batch, seq in ((256, 4, 32), (32000, 2, 100)):
        jcfg = JD.DataConfig(vocab=vocab, batch=batch, seq=seq, seed=seed)
        tcfg = TD.DataConfig(vocab=vocab, batch=batch, seq=seq, seed=seed)
        for step in (0, 1, 7, 123):
            want = JD.batch_at(jcfg, step)
            got = TD.batch_at(tcfg, step, device="cpu")
            for key in ("tokens", "labels"):
                assert got[key].dtype == torch.int32
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(want[key]))


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 1024], ids=["chunks16", "default"])
def test_attention_chunked_matches_jax_and_full(chunk):
    jp = jax_params(TINY)
    tp = carry(jp, TINY)
    x = (np.random.default_rng(1).standard_normal((2, 64, TINY.d_model))
         ).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    want = np.asarray(jax.jit(lambda p, a: JL.attention_chunked(
        p, a, TINY, q_chunk=chunk, kv_chunk=chunk))(jattn, jnp.asarray(x)))
    with torch.no_grad():
        tx = torch.from_numpy(x)
        got = TL.attention_chunked(tp.layers[0]["attn"], tx, port_cfg(TINY),
                                   q_chunk=chunk, kv_chunk=chunk)
        full = TL.attention_full(tp.layers[0]["attn"], tx, port_cfg(TINY))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-5)


def test_attention_chunked_rejects_uneven_chunks():
    tp = TM.init_params(None, port_cfg(TINY), device="cpu")
    with pytest.raises(ValueError, match="multiple of the chunks"):
        TL.attention_chunked(tp.layers[0]["attn"], torch.zeros(1, 40, 64),
                             port_cfg(TINY), q_chunk=16, kv_chunk=16)
    with pytest.raises(ValueError, match="attn_impl"):
        TM.forward(tp, port_cfg(TINY), torch.zeros(1, 4, dtype=torch.int32),
                   attn_impl="flash")


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def port_loss_and_grads(tp, cfg, toks, labels, attn_impl, remat):
    loss = TM.loss_fn(tp, port_cfg(cfg), torch.from_numpy(toks),
                      torch.from_numpy(labels), remat=remat,
                      attn_impl=attn_impl)
    names, ps = zip(*tp.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, ps)))


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("attn_impl", ["full", "chunked"])
def test_loss_and_grads_match_jax(cfg, attn_impl):
    jp = jax_params(cfg)
    tp = carry(jp, cfg)
    toks = tokens((2, 32), cfg.vocab, seed=5)
    labels = tokens((2, 32), cfg.vocab, seed=6)
    got = {}
    for remat in (False, True):
        got[remat] = port_loss_and_grads(tp, cfg, toks, labels, attn_impl,
                                         remat)
    # remat recomputes the same float ops: bitwise the same loss and grads
    assert torch.equal(got[False][0], got[True][0])
    for n, g in got[False][1].items():
        assert torch.equal(g, got[True][1][n]), n

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jnp.asarray(toks), jnp.asarray(labels),
                             remat=True, attn_impl=attn_impl)))(jp)
    np.testing.assert_allclose(float(got[True][0]), float(jloss), rtol=1e-5)
    jgrads = to_numpy(jgrads)
    for n, g in got[True][1].items():
        want = jax_leaf(jgrads, n)
        scale = np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


@pytest.mark.parametrize("attn_impl", ["full", "chunked"])
def test_make_loss_and_grads_is_the_loss_fn_and_its_gradients(attn_impl):
    """The step's loss-and-gradient builder: in float32 the same bits as
    `loss_fn` and `autograd.grad`; with the bf16 compute copy, a loss near
    the float32 one and finite float32 gradients of every parameter."""
    tp = carry(jax_params(TINY), TINY)
    toks = tokens((2, 32), TINY.vocab, seed=5)
    labels = tokens((2, 32), TINY.vocab, seed=6)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    want_loss, want = port_loss_and_grads(tp, TINY, toks, labels, attn_impl,
                                          remat=True)
    loss, grads = make_loss_and_grads(port_cfg(TINY), compute_dtype=None,
                                      attn_impl=attn_impl)(tp, batch)
    assert torch.equal(loss, want_loss)
    assert list(grads) == list(want)
    for n, g in grads.items():
        assert torch.equal(g, want[n]), n
    loss16, grads16 = make_loss_and_grads(port_cfg(TINY),
                                          attn_impl=attn_impl)(tp, batch)
    np.testing.assert_allclose(float(loss16), float(want_loss), rtol=2e-2)
    assert list(grads16) == list(want)
    for n, g in grads16.items():
        assert g.dtype == torch.float32 and g.shape == want[n].shape, n
        assert torch.isfinite(g).all(), n


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def grads_tree(jp, seed):
    """Seeded gradients shaped like the JAX parameter tree."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2
                                   ).astype(np.float32), to_numpy(jp))


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("codec", ["f32", "q8"])
def test_adamw_matches_jax(cfg, codec):
    """The JAX update runs op by op, as written: under `jax.jit` XLA fuses
    `b1 * m + (1 - b1) * g` into a fused multiply-add, which rounds once
    where the written ops (and the port's) round twice, and a moment that
    nearly cancels then differs far beyond rtol 1e-6."""
    jp = jax_params(cfg)
    tp = carry(jp, cfg)
    jopt = JAdamWConfig(lr=1e-3, state_codec=codec)
    topt = AdamWConfig(lr=1e-3, state_codec=codec)
    jstate = j_adamw_init(jp, jopt)
    tstate = interop.opt_state_from_numpy(to_numpy(jstate), tp, "cpu")
    fresh = adamw_init(tp, topt)
    assert tstate["step"].dtype == fresh["step"].dtype == torch.int32
    for n, mom in fresh["moments"].items():
        assert {k: (v.shape, v.dtype) for k, v in mom.items()} == \
            {k: (v.shape, v.dtype) for k, v in tstate["moments"][n].items()}
    for update in range(3):
        g = grads_tree(jp, seed=update)
        jp, jstate = j_adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                    jstate, jopt)
        tgrads = named(interop.params_from_numpy(g, port_cfg(cfg), "cpu"))
        tp, tstate = adamw_update(tp, tgrads, tstate, topt)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    jax.tree.map(lambda got, want: np.testing.assert_allclose(
        got, want, rtol=0, atol=1e-7), interop.params_to_numpy(tp),
        to_numpy(jp))
    jm = to_numpy(jstate["moments"])
    off_by_one = total = 0
    for n, mom in tstate["moments"].items():
        want = {k: jax_leaf(jm, f"{n}.{k}") for k in mom}
        if codec == "f32":
            for k in ("m", "v"):
                np.testing.assert_allclose(mom[k].numpy(), want[k],
                                           rtol=1e-6, err_msg=f"{n} {k}")
            continue
        for k in ("m_s", "v_s"):
            np.testing.assert_allclose(mom[k].numpy(), want[k], rtol=1e-6,
                                       err_msg=f"{n} {k}")
        for k in ("m_q", "v_q"):
            d = np.abs(mom[k].numpy().astype(np.int32) - want[k])
            assert d.max() <= 1, f"{n} {k}"
            off_by_one += int((d != 0).sum())
            total += d.size
    if codec == "q8":
        print(f"q8 moments one level apart: {off_by_one} of {total}")
        assert off_by_one <= 1e-4 * total


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

LR = 1e-3


def run_steps(cfg, codec, compute, steps=3):
    jp = jax_params(cfg)
    tp = carry(jp, cfg)
    jopt = JAdamWConfig(lr=LR, state_codec=codec)
    topt = AdamWConfig(lr=LR, state_codec=codec)
    jstate = j_adamw_init(jp, jopt)
    tstate = interop.opt_state_from_numpy(to_numpy(jstate), tp, "cpu")
    jstep = jax.jit(j_make_train_step(
        cfg, jopt, grad_compression="q8",
        compute_dtype=None if compute is None else jnp.bfloat16))
    tstep = make_train_step(port_cfg(cfg), topt, grad_compression="q8",
                            compute_dtype=compute)
    jcfg = JD.DataConfig(vocab=cfg.vocab, batch=4, seq=32, seed=1)
    tcfg = TD.DataConfig(vocab=cfg.vocab, batch=4, seq=32, seed=1)
    losses = []
    for s in range(steps):
        jp, jstate, jloss = jstep(jp, jstate, JD.batch_at(jcfg, s))
        tp, tstate, tloss = tstep(tp, tstate, TD.batch_at(tcfg, s, "cpu"))
        losses.append((float(tloss), float(jloss)))
    return tp, to_numpy(jp), losses


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("codec", ["f32", "q8"])
def test_train_step_matches_jax(cfg, codec):
    """Float32 compute.  Adam's first updates are near sign(g) * lr, so an
    element whose gradient is within rounding of 0 (|g| <~ eps), or whose
    q8 wire value sits on a rounding boundary, can move by up to 2 lr more
    in one package than in the other; such elements are rare (<= 0.1 %) and
    the difference is bounded by 6 lr after three steps."""
    tp, jp, losses = run_steps(cfg, codec, None)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert losses[-1][0] < losses[0][0]
    d = jax.tree.leaves(jax.tree.map(lambda got, want: np.abs(got - want),
                                     interop.params_to_numpy(tp), jp))
    assert max(a.max() for a in d) <= 6 * LR
    far = sum(int((a > 1e-5).sum()) for a in d)
    total = sum(a.size for a in d)
    print(f"params beyond atol 1e-5: {far} of {total}")
    assert far <= 1e-3 * total


@pytest.mark.parametrize("codec", ["f32", "q8"])
def test_train_step_bf16_compute_matches_jax(codec):
    _, _, losses = run_steps(TINY, codec, torch.bfloat16)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=2e-2)


def test_prefill_and_decode_steps():
    jp = jax_params(TINY)
    tp = carry(jp, TINY)
    toks = tokens((2, 16), TINY.vocab, seed=3)
    want = j_make_prefill_step(TINY)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = make_prefill_step(port_cfg(TINY))(
            tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    cfg = port_cfg(TINY)
    state = TM.init_serve_state(cfg, 2, 8, kv_dtype=torch.float32,
                                device="cpu")
    t0 = torch.from_numpy(toks[:, :1])
    logits, _ = make_decode_step(cfg)(tp, state, t0)
    again, _ = TM.decode_step(tp, TM.init_serve_state(
        cfg, 2, 8, kv_dtype=torch.float32, device="cpu"), cfg, t0)
    assert torch.equal(logits, again)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_prefill_act_specs_checked_and_logits_unchanged(mode):
    """`make_prefill_step(cfg, act_specs=)`: the reference's activation
    specs on a 1x1 mesh (or no mesh) give the call without specs' logits,
    bit for bit, and the JAX prefill's within the test's tolerances; a
    model axis larger than 1 raises (tensor parallelism is not ported),
    also in a spec's batch dimension."""
    from repro.distributed import sharding as JS
    from repro_torch.distributed.sharding import DistConfig, activation_specs
    from repro_torch.launch.mesh import MeshShape
    jp = jax_params(TINY)
    tp = carry(jp, TINY)
    toks = tokens((2, 16), TINY.vocab, seed=5)
    act = activation_specs(DistConfig(parallel_mode=mode))
    specs = {"hidden": act["hidden"], "logits": act["logits"]}
    assert specs == {k: tuple(v) for k, v in JS.activation_specs(
        JS.DistConfig(parallel_mode=mode)).items() if k in specs}
    cfg = port_cfg(TINY)
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        plain = make_prefill_step(cfg)(tp, batch)
        for mesh in (None, MeshShape(("data", "model"), (1, 1))):
            got = make_prefill_step(cfg, act_specs=specs, mesh=mesh)(tp,
                                                                     batch)
            assert torch.equal(got, plain)
    want = j_make_prefill_step(TINY, act_specs=None)(
        jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="tensor parallelism"):
        make_prefill_step(cfg, act_specs=specs,
                          mesh=MeshShape(("data", "model"), (1, 16)))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(TA, name, getattr(JR, name))


@pytest.mark.parametrize("budget", [16e9, 1e5])
def test_trainer_matches_jax_trainer(jax_constants, budget):
    kw = dict(steps=4, batch=4, seq=32, lr=1e-2, hbm_budget_bytes=budget,
              log_every=1000)
    jt = JLOOP.Trainer(TINY, JLOOP.TrainConfig(checkpoint_dir=None, **kw))
    tt = TLOOP.Trainer(port_cfg(TINY), TLOOP.TrainConfig(**kw),
                       device="cpu")
    assert tt.plan.choices == jt.plan.choices
    assert (tt.plan.hbm_bytes, tt.plan.step_cost_s) == \
        (jt.plan.hbm_bytes, jt.plan.step_cost_s)
    assert tt.opt_cfg.state_codec == jt.opt_cfg.state_codec
    tt.params = carry(jt.params, TINY)
    tt.opt_state = interop.opt_state_from_numpy(to_numpy(jt.opt_state),
                                                tt.params, "cpu")
    jt.run()
    out = tt.run()
    assert [h["step"] for h in tt.history] == [0, 1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=2e-2)
    assert out["final_loss"] == tt.history[-1]["loss"]


def test_trainer_loss_decreases():
    """The JAX package's own trainer test, on the port."""
    tc = TLOOP.TrainConfig(steps=30, batch=4, seq=32, lr=1e-2,
                           use_design_advisor=False, log_every=1000)
    out = TLOOP.Trainer(port_cfg(TINY), tc, device="cpu").run()
    assert out["final_loss"] < out["first_loss"]


def test_trainer_straggler_hook():
    events = []
    t = TLOOP.Trainer(port_cfg(TINY), TLOOP.TrainConfig(
        steps=6, batch=2, seq=16, straggler_factor=0.0, log_every=1000),
        on_straggler=lambda s, r: events.append(s), device="cpu")
    t.run()
    # step 0 is left out of the EMA and step 1 starts it; every later step
    # is slower than 0 x EMA
    assert t.straggler_events == events == [2, 3, 4, 5]


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only behaviour; the card runs chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TLOOP.Trainer(port_cfg(TINY), TLOOP.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.batch_at(TD.DataConfig(vocab=256, batch=1, seq=4), 0)
