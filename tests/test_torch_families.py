"""Every configuration of the repo, at its smoke size, through the port and
the JAX package on the CPU: the slice as a whole.

For each of the ten architectures (dense, MoE, RWKV6, the Jamba hybrid,
and the vlm / audio stub frontends fed `batch_at`'s bfloat16 embeddings)
the weights of the JAX `init_params` are carried into the port, and
`forward`'s logits, `loss_fn` and its gradients, and `decode_step` over
several steps with `active` masks and a `reset_slot`, with the recurrent
state, are held to the JAX functions.  Besides: `batch_at`'s stub
embeddings bit for bit, the `Trainer` on a stub-frontend architecture
against the JAX `Trainer`, the serving engine's tokens against the JAX
engine's for one architecture of each family, and the training launcher
on the families it did not run before.

Tolerances: logits, losses and state within rtol and atol 1e-5 (float32
op for op; the scans accumulate in the same order); gradients within rtol
1e-4 and atol 1e-6; the Trainer (bfloat16 compute) within rtol 2e-2, as
`test_torch_train.py`'s; embeddings and tokens exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, smoke_config
from repro.data import pipeline as JD
from repro.launch import roofline as JR
from repro.models import model as JM
from repro.serve import engine as JE
from repro.train import loop as JLOOP
from repro_torch.data import pipeline as TD
from repro_torch.design import advisor as TA
from repro_torch.launch import train as launch_train
from repro_torch.models import interop
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE
from repro_torch.train import loop as TLOOP
from torch_port_util import carried_lm, port_model_config


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    cfg = smoke_config(request.param)
    return (cfg,) + carried_lm(cfg)


def batch(cfg, step=0, b=2, s=16):
    """A `batch_at` batch of both packages: tokens, labels and, for a stub
    frontend, its embeddings in float32 (the float32 models' type: the
    JAX layer scan needs its carry to keep its type)."""
    d_model = cfg.d_model if cfg.frontend != "tokens" else 0
    jb = JD.batch_at(JD.DataConfig(cfg.vocab, b, s, seed=3,
                                   d_model=d_model), step)
    tb = TD.batch_at(TD.DataConfig(cfg.vocab, b, s, seed=3,
                                   d_model=d_model), step, device="cpu")
    if d_model:
        jb["embeds"] = jb["embeds"].astype(jnp.float32)
        tb["embeds"] = tb["embeds"].float()
    return jb, tb


def test_forward_loss_and_gradients_match_jax(carried):
    cfg, pc, jp, tp = carried
    jb, tb = batch(cfg)
    assert ("embeds" in tb) == (cfg.frontend != "tokens")
    want = JM.forward(jp, cfg, jb["tokens"], jb.get("embeds"))
    with torch.no_grad():
        got = TM.forward(tp, pc, tb["tokens"], tb.get("embeds"))
    assert got.shape == (2, 16, cfg.vocab_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jb["tokens"], jb["labels"],
                             jb.get("embeds"), remat=True)))(jp)
    loss = TM.loss_fn(tp, pc, tb["tokens"], tb["labels"], tb.get("embeds"),
                      remat=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    names, ps = zip(*tp.named_parameters())
    grads = torch.autograd.grad(loss, ps, materialize_grads=True)
    got_g = interop._jax_tree((n, g.numpy()) for n, g in zip(names, grads))
    assert jax.tree.structure(got_g) == jax.tree.structure(jgrads)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=1e-4, atol=1e-6), got_g, jgrads)


def test_decode_with_active_masks_and_reset_matches_jax(carried):
    cfg, pc, jp, tp = carried
    b = 3
    js = JM.init_serve_state(cfg, b, 8, jnp.float32)
    ts = TM.init_serve_state(pc, b, 8, torch.float32, device="cpu")
    assert sorted(ts) == sorted(js)
    jdec = jax.jit(lambda p, s, t, a: JM.decode_step(p, s, cfg, t, a))
    rng = np.random.default_rng(5)
    for step in range(7):
        toks = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        active = np.array([True, step % 2 == 0, step != 3])
        jl, js = jdec(jp, js, jnp.asarray(toks), jnp.asarray(active))
        tl, ts = TM.decode_step(tp, ts, pc, torch.from_numpy(toks),
                                torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(ts["pos"].numpy(),
                                      np.asarray(js["pos"]))
        for name in ("rwkv", "mamba", "kv"):
            for k, v in ts.get(name, {}).items():
                np.testing.assert_allclose(v.numpy(),
                                           np.asarray(js[name][k]),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{name}/{k}")
        if step == 4:
            js = JM.reset_slot(js, cfg, 2)
            ts = TM.reset_slot(ts, pc, 2)


@pytest.mark.parametrize("seed,d_model", [(0, 64), (3, 5120)])
def test_batch_at_stub_embeddings_are_jaxs_bfloat16_bits(seed, d_model):
    jcfg = JD.DataConfig(vocab=131072, batch=2, seq=24, seed=seed,
                         d_model=d_model)
    tcfg = TD.DataConfig(vocab=131072, batch=2, seq=24, seed=seed,
                         d_model=d_model)
    for step in (0, 1, 9):
        want = np.asarray(JD.batch_at(jcfg, step)["embeds"])
        got = TD.batch_at(tcfg, step, device="cpu")["embeds"]
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    assert "embeds" not in TD.batch_at(TD.DataConfig(256, 2, 4), 0, "cpu")


def test_stub_frontend_trainer_matches_jax_trainer(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(TA, name, getattr(JR, name))
    cfg = smoke_config("pixtral-12b")
    kw = dict(steps=3, batch=4, seq=32, lr=1e-2, hbm_budget_bytes=16e9,
              log_every=1000)
    jt = JLOOP.Trainer(cfg, JLOOP.TrainConfig(checkpoint_dir=None, **kw))
    pc = port_model_config(cfg)
    tt = TLOOP.Trainer(pc, TLOOP.TrainConfig(**kw), device="cpu")
    assert tt.data_cfg.d_model == cfg.d_model
    assert tt.plan.choices == jt.plan.choices
    tt.params = interop.params_from_numpy(jax.tree.map(np.asarray,
                                                       jt.params), pc, "cpu")
    tt.opt_state = interop.opt_state_from_numpy(
        jax.tree.map(np.asarray, jt.opt_state), tt.params, "cpu")
    jt.run()
    tt.run()
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=2e-2)


FAMILIES = ["tinyllama-1.1b", "granite-moe-3b-a800m", "rwkv6-7b",
            "jamba-1.5-large-398b", "pixtral-12b", "musicgen-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_tokens_equal_the_jax_engine(arch):
    cfg = smoke_config(arch)
    pc, jp, tp = carried_lm(cfg, seed=2)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(1, 6)).tolist()
               for _ in range(5)]

    def serve(eng, make):
        for uid, p in enumerate(prompts):
            eng.submit(make(uid=uid, prompt=list(p), max_new_tokens=4))
            eng.step()
        eng.run_until_drained()
        return {u: (r.out_tokens, r.truncated)
                for u, r in eng.finished.items()}, eng.steps

    want = serve(JE.ServeEngine(cfg, jp, JE.EngineConfig(
        batch_slots=2, max_len=16, kv_dtype="f32")), JE.Request)
    got = serve(TE.ServeEngine(pc, tp, TE.EngineConfig(
        batch_slots=2, max_len=16, kv_dtype="f32"), device="cpu"),
        TE.Request)
    assert got == want


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b",
                                  "musicgen-medium"])
def test_launcher_trains_every_family(arch, capsys):
    trainer = launch_train.main(["--arch", arch, "--steps", "2", "--batch",
                                 "2", "--seq", "16", "--device", "cpu"])
    assert trainer.step == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert f"{arch}-smoke" in capsys.readouterr().out
