"""Training the Jamba hybrid in the port against the JAX package, on the
CPU: `make_train_step` on its smoke configuration (seven Mamba blocks and
one attention layer, MoE on every other position) with the q8 wire, q8
moments, float32 compute and per-layer (per-group) remat, at a sequence of
two Mamba chunks of 128, held to the jitted JAX step within
`test_torch_train.py`'s tolerances (`test_torch_train_families.
recurrent_step_matches_jax`).  The wire carries partial q8 blocks of last
dimensions 8, 16, 36 and 64.

Besides, the Trainer at the training launcher's smoke settings against the
JAX Trainer, through the loss rise that the plan's q8 moments and q8 wire
give it at lr 1e-3.  A file of its own: it takes about two minutes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config
from repro.launch import roofline as JR
from repro.optim import adamw_init as j_adamw_init
from repro.train import loop as JLOOP
from repro_torch.design import advisor as TA
from repro_torch.models import interop
from repro_torch.train import loop as TLOOP
from test_torch_train_families import recurrent_step_matches_jax
from torch_port_util import port_model_config

HYBRID = "jamba-1.5-large-398b"
# `launch/train.py`'s defaults for a smoke configuration, at the port
# launcher's 80 GB budget
LAUNCH = dict(steps=5, batch=4, seq=64, lr=1e-3, hbm_budget_bytes=80e9,
              log_every=1000)
# an init of the port's (its CPU generator's seed) from which the rise shows
# within five steps; from seed 0 on the CPU it does not, from the card's
# seed-0 init it does (chip_smoke.py phase 10e)
RISE_SEED = 9


def test_hybrid_train_step_matches_jax():
    recurrent_step_matches_jax(HYBRID, 256)


@pytest.mark.parametrize("advisor", [True, False],
                         ids=["plan-q8-moments-and-wire", "f32-moments"])
def test_launcher_trainer_matches_jax_through_a_q8_loss_rise(monkeypatch,
                                                             advisor):
    """Both Trainers on the Jamba smoke at the launcher's settings, from
    the port's seed-RISE_SEED init carried into the JAX one and the same
    batches, losses within rtol 2e-2 (as `test_torch_moe.py::
    test_moe_trainer_matches_jax_trainer`).  With the plan's q8 moments
    and q8 wire the loss rises above the first at step 3 and ends above
    it in both packages: the reference's own behaviour, not the port's.
    With float32 moments and no wire (the advisor off), from the same
    weights, it falls at every step in both."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(TA, name, getattr(JR, name))
    cfg = smoke_config(HYBRID)
    kw = dict(LAUNCH, seed=RISE_SEED, use_design_advisor=advisor)
    jt = JLOOP.Trainer(cfg, JLOOP.TrainConfig(checkpoint_dir=None, **kw))
    tt = TLOOP.Trainer(port_model_config(cfg), TLOOP.TrainConfig(**kw),
                       device="cpu")
    want = "q8" if advisor else "f32"
    assert tt.opt_cfg.state_codec == jt.opt_cfg.state_codec == want
    assert tt.grad_compression == ("q8" if advisor else None)
    if advisor:
        assert tt.plan.choices == jt.plan.choices
    jt.params = jax.tree.map(jnp.asarray, interop.params_to_numpy(tt.params))
    jt.opt_state = j_adamw_init(jt.params, jt.opt_cfg)
    jt.run()
    tt.run()
    got = [h["loss"] for h in tt.history]
    ref = [h["loss"] for h in jt.history]
    np.testing.assert_allclose(got, ref, rtol=2e-2)
    for losses in (got, ref):
        if advisor:
            assert losses[3] > losses[0] and losses[-1] > losses[0]
        else:
            assert all(b < a for a, b in zip(losses, losses[1:]))
