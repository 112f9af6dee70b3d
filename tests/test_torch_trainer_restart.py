"""The port's `Trainer` restart and training launcher, on the CPU.

Twins of `tests/test_runtime.py::TestTrainer`'s
`test_checkpoint_restart_resumes` and
`test_restart_preserves_loss_trajectory`, made stronger: a run saved,
dropped and resumed gives the losses and final parameters of a run that
was never interrupted, bitwise (float32 moments without the advisor, and
the advisor's q8 moments and q8 gradient wire).  A JAX `Trainer`'s
checkpoint at step k is resumed by the port's `Trainer` with parameters
and moments bit-equal to the JAX state, its losses then within the rtol
2e-2 that `tests/test_torch_train.py::test_trainer_matches_jax_trainer`
allows against the jitted JAX trainer.  The launcher
(`repro_torch.launch.train.main`) resumes from its own directory.
"""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import roofline as JR
from repro.models.config import ModelConfig
from repro.train import loop as JLOOP
from repro_torch.checkpoint import CheckpointManager
from repro_torch.design import advisor as TA
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import interop
from repro_torch.models.config import ModelConfig as PortModelConfig
from repro_torch.train import loop as TLOOP

TINY = ModelConfig("tiny", "dense", 2, 64, 4, 2, 128, 256, d_head=16)


def port_cfg(cfg):
    return PortModelConfig(**dataclasses.asdict(cfg))


def trainer(tc):
    return TLOOP.Trainer(port_cfg(TINY), tc, device="cpu")


def state_bits(t):
    """{key: [tensors]} of a trainer's parameters and optimizer state, as
    integer views (bitwise comparisons)."""
    out = {}
    for k, (_, ts) in interop.checkpoint_leaves(t.params,
                                                t.opt_state).items():
        out[k] = [x.detach().clone().view(torch.int32)
                  if x.dtype == torch.float32 else x.detach().clone()
                  for x in ts]
    return out


def assert_same_state(a, b):
    assert list(a) == list(b)
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert torch.equal(x, y), k


def losses(t):
    return [h["loss"] for h in t.history]


def test_checkpoint_restart_resumes(tmp_path):
    tc = TLOOP.TrainConfig(steps=10, batch=2, seq=16, checkpoint_every=5,
                           checkpoint_dir=str(tmp_path / "ck"),
                           use_design_advisor=False, log_every=1000)
    t1 = trainer(tc)
    t1.run()
    assert t1.step == 10
    # new trainer resumes from the latest checkpoint
    t2 = trainer(tc)
    assert t2.step == 10
    t2.run(steps=3)
    assert t2.step == 13


@pytest.mark.parametrize("advisor", [False, True], ids=["f32", "q8"])
def test_resumed_run_equals_uninterrupted_run(tmp_path, advisor):
    """Determinism across restart, bitwise: same data, same state => same
    losses and parameters."""
    kw = dict(steps=6, batch=2, seq=16, lr=1e-3, log_every=1000,
              use_design_advisor=advisor, hbm_budget_bytes=1e5)
    whole = trainer(TLOOP.TrainConfig(**kw))
    whole.run()
    assert whole.opt_cfg.state_codec == ("q8" if advisor else "f32")
    ckdir = str(tmp_path / "ck")
    tc = TLOOP.TrainConfig(**{**kw, "steps": 3}, checkpoint_every=100,
                           checkpoint_dir=ckdir, keep_last_k=1)
    first = trainer(tc)
    first.run()
    saved = state_bits(first)
    del first
    second = trainer(tc)
    assert second.step == 3
    assert_same_state(state_bits(second), saved)
    second.run()
    assert second.step == 6
    assert [h["step"] for h in second.history] == [3, 4, 5]
    assert losses(second) == losses(whole)[3:]
    assert_same_state(state_bits(second), state_bits(whole))
    assert CheckpointManager(second.ckpt.cfg).latest_step() == 6


def test_restart_preserves_loss_trajectory(tmp_path):
    """The reference test's own sequence: 6 steps saved every 3, resumed
    twice."""
    ckdir = str(tmp_path / "ck2")
    tc = TLOOP.TrainConfig(steps=6, batch=2, seq=16, checkpoint_every=3,
                           checkpoint_dir=ckdir, use_design_advisor=False,
                           lr=1e-3, log_every=1000)
    t1 = trainer(tc)
    t1.run()
    losses_full = losses(t1)
    t2 = trainer(tc)  # resumes at step 6
    assert t2.step == 6
    t2.run(steps=2)
    t3 = trainer(tc)  # resumes at step 8
    assert t3.step == 8
    # the same data and state give the same losses as a run from step 0
    whole = trainer(dataclasses.replace(tc, checkpoint_dir=None, steps=8))
    whole.run()
    assert losses(whole) == losses_full + losses(t2)


def test_run_saves_every_k_steps_and_at_the_end(tmp_path):
    tc = TLOOP.TrainConfig(steps=5, batch=2, seq=16, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / "ck"),
                           keep_last_k=5, use_design_advisor=False,
                           log_every=1000)
    t = trainer(tc)
    t.run()
    dirs = [d.name for d in sorted((tmp_path / "ck").glob("step_*"))]
    assert dirs == ["step_00000002", "step_00000004", "step_00000005"]
    man = json.loads((tmp_path / "ck" / "step_00000005" /
                      "manifest.json").read_text())
    assert man["step"] == 5 and man["extra"] == {"loss": losses(t)[-1]}
    assert {m["codec"] for m in man["leaves"].values()} == {"zlib",
                                                            "raw+zlib"}


def test_restore_needs_a_checkpoint_dir():
    t = trainer(TLOOP.TrainConfig(steps=1, batch=2, seq=16,
                                  use_design_advisor=False))
    assert t.ckpt is None
    with pytest.raises(ValueError, match="checkpoint_dir"):
        t.restore()


@pytest.fixture
def jax_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(TA, name, getattr(JR, name))


@pytest.mark.parametrize("budget", [16e9, 1e5])
def test_port_trainer_resumes_a_jax_trainer_checkpoint(tmp_path,
                                                       jax_constants,
                                                       budget):
    ckdir = str(tmp_path / "ck")
    kw = dict(batch=4, seq=32, lr=1e-2, hbm_budget_bytes=budget,
              log_every=1000, checkpoint_every=100)
    jt = JLOOP.Trainer(TINY, JLOOP.TrainConfig(steps=3, checkpoint_dir=ckdir,
                                               **kw))
    jt.run()
    tt = TLOOP.Trainer(port_cfg(TINY), TLOOP.TrainConfig(
        steps=3, checkpoint_dir=ckdir, **kw), device="cpu")
    assert tt.step == 3
    assert tt.opt_cfg.state_codec == jt.opt_cfg.state_codec
    jax.tree.map(np.testing.assert_array_equal,
                 interop.params_to_numpy(tt.params),
                 jax.tree.map(np.asarray, jt.params))
    jax.tree.map(np.testing.assert_array_equal,
                 interop.opt_state_to_numpy(tt.opt_state, tt.params),
                 jax.tree.map(np.asarray, jt.opt_state))
    jt.run()
    tt.run()
    assert [h["step"] for h in tt.history] == [3, 4, 5]
    np.testing.assert_allclose(losses(tt), losses(jt)[3:], rtol=2e-2)


def test_launcher_resumes_from_its_directory(tmp_path, capsys):
    ckdir = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--arch", "tinyllama-1.1b", "--batch", "2",
            "--seq", "16", "--checkpoint-dir", ckdir]
    t1 = TLAUNCH.main(argv + ["--steps", "4"])
    assert t1.step == 4
    t2 = TLAUNCH.main(argv + ["--steps", "2"])
    assert [h["step"] for h in t2.history] == [4, 5] and t2.step == 6
    assert t2.cfg.name == "tinyllama-1.1b-smoke"
    out = capsys.readouterr().out
    assert "[trainer] resumed from step 4" in out
    assert sorted(p.name for p in Path(ckdir).glob("step_*")) == [
        "step_00000004", "step_00000006"]


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only behaviour; the card runs chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TLAUNCH.main(["--steps", "1"])
