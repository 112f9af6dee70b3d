"""The port's Mamba block and the Jamba hybrid against the JAX package, on
the CPU.

`softplus` (JAX's `logaddexp(x, 0)`, also above 20 where torch's
`F.softplus` turns linear), `_causal_conv` with a carried-in ring buffer,
`mamba_sequence` over a prefill and then decode steps from the carried
conv and SSM state; and on a two-group variant of `jamba-1.5-large-398b`'s
smoke configuration (so that a block's name holds two indices, group and
block): the parameters' round trip through NumPy, the checkpoint's leaf
keys and bytes against the JAX `CheckpointManager` (each package reading
the other's), `decode_step` with `active` masks and `reset_slot` with the
(n_groups, n_mamba, B, ...) state, and the engine's mid-flight invariant
and tokens against the JAX engine.

Tolerances: softplus and the conv within rtol 1e-6 and atol 1e-7; the
Mamba block's outputs and states within rtol and atol 1e-5 (the SSM scan
runs in float32 in the same order); logits and state within rtol and atol
1e-5; checkpoints, round trips and tokens exact.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.checkpoint.manager import CheckpointConfig as JCheckpointConfig
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import smoke_config
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.serve import engine as JE
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.models import interop
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serve import engine as TE
from torch_port_util import (carried_lm, midflight_tokens,
                             port_model_config)

JAMBA = smoke_config("jamba-1.5-large-398b")
JAMBA2 = dataclasses.replace(JAMBA, name="jamba-smoke-2groups", n_layers=16)


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def test_softplus_is_jaxs():
    x = np.concatenate([np.linspace(-60, 60, 4001, dtype=np.float32),
                        np.array([0.0, -0.0, 19.99, 20.0, 20.01, 88.0,
                                  -88.0, 1e-8], np.float32)])
    got = TMB.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_causal_conv_carries_the_ring_buffer():
    x, w, b = normal((2, 5, 12), 0), normal((4, 12), 1), normal((12,), 2)
    prev = normal((2, 3, 12), 3)
    want = JMB._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            jnp.asarray(prev))
    got = TMB._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), torch.from_numpy(prev))
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-7)


def test_mamba_prefill_then_decode_matches_jax():
    cfg = JAMBA
    jp = JMB.init_mamba_block(jax.random.PRNGKey(4), cfg)
    tp = nn.ParameterDict({k: nn.Parameter(torch.from_numpy(np.array(v)))
                           for k, v in jp.items()})
    pc = port_model_config(cfg)
    b, din, ds = 3, TMB.d_inner(pc), pc.hybrid.d_state
    assert (din, TMB.dt_rank(pc)) == (JMB.d_inner(cfg), JMB.dt_rank(cfg))
    st = JMB.init_mamba_state(cfg, b, 1)
    jconv, jssm = st["conv"][0], st["ssm"][0]
    tst = TMB.init_mamba_state(pc, b, 1, device="cpu")
    tconv, tssm = tst["conv"][0], tst["ssm"][0]
    x = normal((b, 12, cfg.d_model), 5)
    with torch.no_grad():
        for lo, hi in ((0, 9), (9, 10), (10, 11), (11, 12)):
            jo, jconv, jssm = JMB.mamba_sequence(
                jp, jnp.asarray(x[:, lo:hi]), cfg, jconv, jssm)
            to, tconv, tssm = TMB.mamba_sequence(
                tp, torch.from_numpy(x[:, lo:hi]), pc, tconv, tssm)
            for g, w in ((to, jo), (tconv, jconv), (tssm, jssm)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-5)
    assert tssm.dtype == torch.float32 and tssm.shape == (b, din, ds)


@pytest.fixture(scope="module")
def hybrid():
    return carried_lm(JAMBA2, seed=1)


def test_hybrid_params_round_trip_with_two_stacked_axes(hybrid):
    pc, jp, tp = hybrid
    assert isinstance(tp, TM.HybridLM) and len(tp.groups) == 2
    tree = jax.tree.map(np.asarray, jp)
    back = interop.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert back["groups"]["mamba"]["in_proj"].shape[:2] == (2, 7)
    np.testing.assert_array_equal(
        tp.groups[1]["mamba"][5]["in_proj"].detach().numpy(),
        tree["groups"]["mamba"]["in_proj"][1, 5])


def jax_state(cfg, seed=0):
    params = JM.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    ocfg = JAdamWConfig(state_codec="q8")
    state = j_adamw_init(params, ocfg)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), params)
    return j_adamw_update(params, grads, state, ocfg)


def test_hybrid_checkpoint_equals_the_jax_checkpoint(tmp_path):
    params, state = jax_state(JAMBA2)
    pc = port_model_config(JAMBA2)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), pc,
                                   "cpu")
    ts = interop.opt_state_from_numpy(jax.tree.map(np.asarray, state), tp,
                                      "cpu")
    leaves = interop.checkpoint_leaves(tp, ts)
    lead, ts_ = leaves["params/groups/mamba/in_proj"]
    assert lead == (2, 7) and len(ts_) == 14
    assert ts_[8] is tp.groups[1]["mamba"][1]["in_proj"]
    assert leaves["params/groups/attn/wq"][0] == (2,)
    JCheckpointManager(JCheckpointConfig(str(tmp_path / "jax"))).save(
        3, params, state)
    CheckpointManager(CheckpointConfig(
        str(tmp_path / "port"), params_codec="zstd", moments_codec="zstd",
        raw_codec="raw+zstd")).save(3, tp, ts)
    a, b = tmp_path / "jax" / "step_00000003", tmp_path / "port" / \
        "step_00000003"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert len(names) == 1 + len(leaves)
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    # the port's manager fills a fresh hybrid model from the JAX directory
    fresh = TM.init_params(torch.Generator().manual_seed(5), pc, "cpu")
    fresh_opt = adamw_init(fresh, AdamWConfig(state_codec="q8"))
    CheckpointManager(CheckpointConfig(str(tmp_path / "jax"))).restore_into(
        fresh, fresh_opt)
    jax.tree.map(np.testing.assert_array_equal,
                 interop.params_to_numpy(fresh), jax.tree.map(np.asarray,
                                                              params))
    jax.tree.map(np.testing.assert_array_equal,
                 interop.opt_state_to_numpy(fresh_opt, fresh),
                 jax.tree.map(np.asarray, state))
    # and a q8 checkpoint of its own round-trips through restore_into
    CheckpointManager(CheckpointConfig(str(tmp_path / "q8"),
                                       params_codec="q8+zlib")).save(
        1, fresh, fresh_opt)
    again = TM.init_params(torch.Generator().manual_seed(6), pc, "cpu")
    again_opt = adamw_init(again, AdamWConfig(state_codec="q8"))
    CheckpointManager(CheckpointConfig(str(tmp_path / "q8"))).restore_into(
        again, again_opt)
    for (n, p), (_, q) in zip(fresh.named_parameters(),
                              again.named_parameters()):
        assert (p - q).abs().max() <= 0.01 * p.abs().max() + 1e-6, n


def test_hybrid_decode_and_reset_match_jax(hybrid):
    pc, jp, tp = hybrid
    b = 3
    js = JM.init_serve_state(JAMBA2, b, 8, jnp.float32)
    ts = TM.init_serve_state(pc, b, 8, torch.float32, device="cpu")
    assert ts["mamba"]["conv"].shape == js["mamba"]["conv"].shape == \
        (2, 7, b, 3, 128)
    assert ts["kv"]["k"].shape[0] == 2
    rng = np.random.default_rng(2)
    jdec = jax.jit(lambda p, s, t, a: JM.decode_step(p, s, JAMBA2, t, a))
    for step in range(6):
        toks = rng.integers(0, JAMBA2.vocab, (b, 1)).astype(np.int32)
        active = np.array([True, step % 2 == 0, step != 2])
        jl, js = jdec(jp, js, jnp.asarray(toks), jnp.asarray(active))
        old = {k: v.clone() for k, v in ts["mamba"].items()}
        tl, ts = TM.decode_step(tp, ts, pc, torch.from_numpy(toks),
                                torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(ts["mamba"][k].numpy(),
                                       np.asarray(js["mamba"][k]),
                                       rtol=1e-5, atol=1e-5)
            for slot in np.flatnonzero(~active):
                assert torch.equal(ts["mamba"][k][:, :, slot],
                                   old[k][:, :, slot])
        if step == 3:
            js = JM.reset_slot(js, JAMBA2, 0)
            ts = TM.reset_slot(ts, pc, 0)
            assert not ts["mamba"]["ssm"][:, :, 0].any()
            assert ts["mamba"]["ssm"][:, :, 1].any()


def test_hybrid_midflight_admission_parity():
    """The recurrent invariant on the hybrid: inactive slots' Mamba state
    does not integrate the pad token.  (Its MoE layers couple the slots
    through the experts' capacity, as in the reference; on these prompts
    the greedy tokens hold, in both packages.)"""
    pc, jp, tp = carried_lm(JAMBA, seed=1)
    alone = midflight_tokens(TE, tp, pc, False, device="cpu")
    assert alone == midflight_tokens(TE, tp, pc, True, device="cpu")
    assert alone == midflight_tokens(JE, jp, JAMBA, True)
