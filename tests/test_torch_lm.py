"""The port's dense LM stack and layout advisor against the JAX package, on
the CPU.

Weights come from the JAX package's `init_params` and are carried into
the port (`repro_torch.models.interop`), so both packages compute the same
function; token ids and activations are made with NumPy from a seed.

Tolerances (float32 on both sides, different summation orders):
logits and float32 KV within rtol and atol 1e-5; a bfloat16 KV cache
within one bfloat16 rounding (rtol 1e-2, atol 1e-3), because an f32 value
an ulp apart can round to the neighbouring bfloat16; logits over a bf16
cache within atol 1e-4.  The q8 MLP: int8 weights exact and scales rtol
1e-6 against JAX `quantize_mlp`; outputs within rtol and atol 1e-4 of JAX
`mlp_quantized` with either `use_pallas` setting.  The layout advisor is
pure float64 Python: its classes, costs and plans are equal to JAX's once
the port's three hardware constants are set to the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_config
from repro.design import advisor as JA
from repro.launch import roofline as JR
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ModelConfig, reduced_for_smoke
from repro_torch.configs import get_config as port_get_config
from repro_torch.design import advisor as TA
from repro_torch.launch import roofline as TR
from repro_torch.models import interop
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as PortModelConfig

TINY = ModelConfig("tiny", "dense", 2, 64, 4, 2, 128, 256, d_head=16)
TINY_RELU2 = dataclasses.replace(TINY, name="tiny-relu2", mlp="relu2")
TINYLLAMA_SMOKE = reduced_for_smoke(get_config("tinyllama-1.1b"))
CONFIGS = [TINY, TINY_RELU2, TINYLLAMA_SMOKE]
IDS = [c.name for c in CONFIGS]


def port_cfg(cfg):
    return PortModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def carried(request):
    cfg = request.param
    jp = JM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   port_cfg(cfg), device="cpu")
    return cfg, jp, tp


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_configs_are_the_jax_packages():
    for arch in ARCHS:
        assert dataclasses.asdict(port_get_config(arch)) == \
            dataclasses.asdict(get_config(arch))
        assert port_get_config(arch).param_count(padded=True) == \
            get_config(arch).param_count(padded=True)


def test_forward_logits_match_jax(carried):
    cfg, jp, tp = carried
    toks = tokens((2, 11), cfg.vocab, seed=1)
    want = np.asarray(JM.forward(jp, cfg, jnp.asarray(toks)))
    with torch.no_grad():
        got = TM.forward(tp, port_cfg(cfg), torch.from_numpy(toks))
    assert got.shape == (2, 11, cfg.vocab_p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_decode_steps_with_active_masks_and_reset_match_jax(carried, kv):
    cfg, jp, tp = carried
    pcfg = port_cfg(cfg)
    b, max_len = 3, 8
    js = JM.init_serve_state(cfg, b, max_len,
                             jnp.float32 if kv == "f32" else jnp.bfloat16)
    ts = TM.init_serve_state(pcfg, b, max_len,
                             torch.float32 if kv == "f32" else torch.bfloat16,
                             device="cpu")
    # slot 0 runs to max_len and past it (its writes are dropped), slot 1
    # idles every other step, slot 2 is reset midway (slot reuse)
    rng = np.random.default_rng(2)
    kv_tol = dict(rtol=1e-5, atol=1e-5) if kv == "f32" else \
        dict(rtol=1e-2, atol=1e-3)
    logit_atol = 1e-5 if kv == "f32" else 1e-4
    for step in range(10):
        toks = tokens((b, 1), cfg.vocab, seed=10 + step)
        active = np.array([True, step % 2 == 0, rng.random() < 0.7])
        jl, js = JM.decode_step(jp, js, cfg, jnp.asarray(toks),
                                jnp.asarray(active))
        tl, ts = TM.decode_step(tp, ts, pcfg, torch.from_numpy(toks),
                                torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=logit_atol)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                ts["kv"][name].float().numpy(),
                np.asarray(js["kv"][name].astype(jnp.float32)), **kv_tol)
        np.testing.assert_array_equal(ts["pos"].numpy(),
                                      np.asarray(js["pos"]))
        if step == 5:
            js = JM.reset_slot(js, cfg, 2)
            ts = TM.reset_slot(ts, pcfg, 2)
            np.testing.assert_array_equal(ts["pos"].numpy(),
                                          np.asarray(js["pos"]))
    assert int(ts["pos"][0]) == 10 > max_len


def test_decode_without_active_advances_every_slot(carried):
    cfg, jp, tp = carried
    pcfg = port_cfg(cfg)
    js = JM.init_serve_state(cfg, 2, 4, jnp.float32)
    ts = TM.init_serve_state(pcfg, 2, 4, torch.float32, device="cpu")
    toks = tokens((2, 1), cfg.vocab, seed=3)
    jl, js = JM.decode_step(jp, js, cfg, jnp.asarray(toks))
    tl, ts = TM.decode_step(tp, ts, pcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    assert ts["pos"].tolist() == [1, 1]


MLP_CASES = [("swiglu", 128, 256, (2, 16)), ("relu2", 128, 384, (2, 16)),
             ("swiglu", 128, 256, (1, 8))]


@pytest.mark.parametrize("kind,d,f,lead", MLP_CASES)
def test_quantized_mlp_matches_jax(kind, d, f, lead):
    cfg = ModelConfig("q", "dense", 1, d, 4, 2, f, 256, d_head=32, mlp=kind)
    p = JL.init_mlp(jax.random.PRNGKey(0), cfg)
    x = (np.random.default_rng(1).standard_normal(lead + (d,)) * 0.5
         ).astype(np.float32)
    pq = JL.quantize_mlp(p)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    tq = TL.quantize_mlp(tp)
    for name in pq:
        np.testing.assert_array_equal(tq[name]["q"].numpy(),
                                      np.asarray(pq[name]["q"]))
        np.testing.assert_allclose(tq[name]["s"].numpy(),
                                   np.asarray(pq[name]["s"]), rtol=1e-6)
    got = TL.mlp_quantized(tq, torch.from_numpy(x), kind).numpy()
    for use_pallas in (False, True):
        want = JL.mlp_quantized(pq, jnp.asarray(x), kind,
                                use_pallas=use_pallas)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    # the carried JAX tree gives the same output as the port's own
    carried_q = interop.quantized_mlp_from_numpy(
        jax.tree.map(np.asarray, pq), device="cpu")
    again = TL.mlp_quantized(carried_q, torch.from_numpy(x), kind).numpy()
    np.testing.assert_array_equal(again, got)
    # and stays within the int8 error bound of the float MLP
    full = TL.mlp(tp, torch.from_numpy(x), kind).numpy()
    assert np.abs(full - got).mean() / (np.abs(full).mean() + 1e-6) < 0.05
    plain = TL.mlp_quantized(tq, torch.from_numpy(x), kind,
                             use_kernel=False).numpy()
    np.testing.assert_array_equal(plain, got)


def test_quantized_mlp_bytes_below_a_third_of_f32():
    cfg = PortModelConfig("q", "dense", 1, 256, 4, 2, 512, 256, d_head=64)
    g = torch.Generator().manual_seed(0)
    p = TL.init_mlp(g, cfg, device="cpu")
    pq = TL.quantize_mlp(p)
    raw = sum(w.numel() * w.element_size() for _, w in p.items())
    q = sum(t.numel() * t.element_size() for w in pq.values()
            for t in w.values())
    assert q < 0.35 * raw


@pytest.fixture
def jax_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(TA, name, getattr(JR, name))


JOBS = [("train", 8, 2048, 16), ("serve", 4, 256, 1), ("serve", 64, 4096, 8)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,batch,seq,chips", JOBS)
def test_layout_advisor_equals_jax_with_its_constants(jax_constants, arch,
                                                      kind, batch, seq,
                                                      chips):
    jcfg, tcfg = get_config(arch), port_get_config(arch)
    jcls = JA.job_tensor_classes(jcfg, kind, batch, seq, chips)
    tcls = TA.job_tensor_classes(tcfg, kind, batch, seq, chips)
    assert [dataclasses.astuple(c) for c in tcls] == \
        [dataclasses.astuple(c) for c in jcls]
    first = {c.name: c.allowed[0] for c in jcls}
    last = {c.name: c.allowed[-1] for c in jcls}
    for choice in (first, last):
        for flops in (0.0, 1e15):
            assert TA.step_cost(tcls, choice, flops) == \
                JA.step_cost(jcls, choice, flops)
    need = JA.step_cost(jcls, first, 0.0)[0]
    for budget in (2.0 * need, 0.5 * need, 0.2 * need, 0.01 * need):
        jp = JA.plan_layout(jcfg, kind, batch, seq, chips, budget)
        tp = TA.plan_layout(tcfg, kind, batch, seq, chips, budget)
        assert (tp.choices, tp.hbm_bytes, tp.step_cost_s, tp.log) == \
            (jp.choices, jp.hbm_bytes, jp.step_cost_s, jp.log)


def test_port_constants_are_the_h100s():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert TA.PEAK_FLOPS == TR.PEAK_FLOPS and TA.HBM_BW == TR.HBM_BW


@pytest.mark.parametrize("budget", [80e9, 1.5e9])
def test_h100_plan_picks_q8_weights_for_tinyllama_serving(budget):
    cfg = port_get_config("tinyllama-1.1b")
    plan = TA.plan_layout(cfg, "serve", batch=4, seq=256, n_chips=1,
                          hbm_budget_bytes=budget)
    assert plan.choices["weights"] == "q8"
    assert plan.hbm_bytes <= 1.5e9
    # f32 and bf16 weights alone miss the 1.5 GB budget
    n = cfg.param_count(padded=True)
    assert 2.0 * n > 1.5e9


@pytest.mark.parametrize("arch", ARCHS)
def test_model_builds_every_family(arch):
    """Each smoke configuration builds on the CPU, as a `HybridLM` for the
    hybrid and a `UniformLM` otherwise, and its parameters, as a JAX-layout
    tree, have the names and shapes of the JAX package's `init_params`."""
    cfg = reduced_for_smoke(port_get_config(arch))
    model = TM.init_params(None, cfg, device="cpu")
    assert isinstance(model, TM.HybridLM if cfg.hybrid else TM.UniformLM)
    got = jax.tree.map(lambda a: a.shape, interop.params_to_numpy(model))
    want = jax.tree.map(lambda a: a.shape,
                        JM.params_shape(reduced_for_smoke(get_config(arch))))
    assert got == want


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert TM.init_params(None, port_cfg(TINYLLAMA_SMOKE)).embed.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_params(None, port_cfg(TINYLLAMA_SMOKE))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.UniformLM(torch.Generator(), port_cfg(TINYLLAMA_SMOKE))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_serve_state(port_cfg(TINYLLAMA_SMOKE), 2, 8)
