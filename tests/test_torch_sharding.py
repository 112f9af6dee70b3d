"""The port's distribution slice against the JAX package, on the CPU.

* Specs: `repro_torch.distributed.sharding.param_specs` equals the
  reference's `PartitionSpec` (as a tuple) for every JAX leaf of every
  architecture (padded for a 16-way model axis, as the dry run pads), with
  tensor and FSDP parallelism, the sequence-sharded KV cache and FSDP over
  pods, on 1x1, 16x16 and 2x16x16 meshes; the port's per-layer tensor
  takes the stacked leaf's spec without its leading (None) entries.  The
  reference's spec functions read only `mesh.shape`, so its mesh is a
  namespace of axis sizes.  The serving-state specs at batch 8 and 1 and
  the activation specs, likewise.
* `placements`, `pad_for_tp` (function-preserving padded heads, as the
  reference's test), `batch_at(sharding=)`, `make_production_mesh`'s
  world-size check.
* The sharded training step on a 1x1 gloo mesh (`Trainer.reshard`'s
  FSDP2), smoke config and q8 wire: losses and parameters bit-equal to the
  port's unsharded step, and within `tests/test_torch_train.py`'s bounds of
  the JAX package's unsharded `make_train_step` (the reference's own
  sharded test fails on this tree, ROADMAP.md Queue C).  `reshard`, then a
  checkpoint save and restore, round-trips.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.data import pipeline as JD
from repro.distributed import sharding as RS
from repro.models import model as JM
from repro.models.config import pad_for_tp as ref_pad_for_tp
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.data import pipeline as TD
from repro_torch.distributed import sharding as PS
from repro_torch.launch import mesh as PM
from repro_torch.models import interop
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.models.config import pad_for_tp
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import loop as TLOOP
from repro_torch.train.step import make_train_step

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DISTS = {"tp": {}, "fsdp": {"parallel_mode": "fsdp"},
         "kv_seq": {"kv_seq_shard": True},
         "fsdp_over_pod": {"fsdp_over_pod": True}}
LR = 1e-3


def meshes(name):
    sizes, axes = MESHES[name]
    return (PM.MeshShape(axes, sizes),
            types.SimpleNamespace(shape=dict(zip(axes, sizes))))


def dists(mode, mesh_name):
    kw = dict(DISTS[mode])
    if mesh_name == "2x16x16":
        kw["pod_axis"] = "pod"
    return PS.DistConfig(**kw), RS.DistConfig(**kw)


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


_MODELS = {}


def arch_pair(arch):
    """(the port's model on the meta device, the reference's parameter
    shapes) of `arch` padded for a 16-way model axis."""
    if arch not in _MODELS:
        cfg = pad_for_tp(get_config(arch), 16)
        _MODELS[arch] = (
            TM.init_params(torch.Generator(), cfg, "meta"),
            JM.params_shape(ref_pad_for_tp(ref_get_config(arch), 16)))
    return _MODELS[arch]


def ref_leaf(tree, name):
    keys, index = interop._split(name)
    for k in keys:
        tree = tree[k]
    return tree, len(index)


def test_archs_are_the_reference_archs():
    assert ARCHS == REF_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", sorted(DISTS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_specs_equal_reference(arch, mode, mesh_name):
    model, shapes = arch_pair(arch)
    mesh, ref_mesh = meshes(mesh_name)
    dist, ref_dist = dists(mode, mesh_name)
    cfg = model.cfg
    got = PS.param_specs(model, cfg, dist, mesh)
    want = RS.param_specs(shapes, None, ref_dist, ref_mesh)
    n_ref = len(jax.tree.leaves(want, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec)))
    leaves = set()
    for name, spec in got.items():
        p, n_stack = ref_leaf(want, name)
        full = tuple(p)
        assert full[:n_stack] == (None,) * n_stack, name
        assert spec == full[n_stack:], name
        leaves.add(tuple(interop._split(name)[0]))
    assert len(leaves) == n_ref


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", sorted(DISTS))
@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("batch", [8, 1])
def test_serve_state_specs_equal_reference(arch, mode, mesh_name, batch):
    cfg = pad_for_tp(get_config(arch), 16)
    ref_cfg = ref_pad_for_tp(ref_get_config(arch), 16)
    mesh, ref_mesh = meshes(mesh_name)
    dist, ref_dist = dists(mode, mesh_name)
    state = TM.init_serve_state(cfg, batch, 64, device="meta")
    ref_state = jax.eval_shape(lambda: JM.init_serve_state(ref_cfg, batch,
                                                           64))
    got = PS.serve_state_specs(state, cfg, dist, mesh, batch)
    want = RS.serve_state_specs(ref_state, ref_cfg, ref_dist, ref_mesh,
                                batch)
    want = jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert got == want


@pytest.mark.parametrize("mode", sorted(DISTS))
@pytest.mark.parametrize("pod", [False, True])
def test_activation_specs_equal_reference(mode, pod):
    dist, ref_dist = dists(mode, "2x16x16" if pod else "16x16")
    want = {k: tuple(v) for k, v in RS.activation_specs(ref_dist).items()}
    assert PS.activation_specs(dist) == want
    for attr in ("dp_axes", "tp_axis", "fsdp_axes"):
        assert getattr(dist, attr) == getattr(ref_dist, attr)


def test_placements():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert PS.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert PS.placements((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert PS.placements((None,), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        PS.placements((("data", "pod"),), mesh)


def test_local_shape():
    mesh, _ = meshes("2x16x16")
    assert PS.local_shape((64, 48, 7), (("pod", "data"), "model", None),
                          mesh) == (2, 3, 7)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", [1, 8, 16])
@pytest.mark.parametrize("pad_kv", [True, False])
def test_pad_for_tp_equals_reference(arch, tp, pad_kv):
    got = pad_for_tp(get_config(arch), tp, pad_kv=pad_kv)
    want = ref_pad_for_tp(ref_get_config(arch), tp, pad_kv=pad_kv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_padded_heads_function_preserving():
    """Zero-weight padded q/kv heads must not change the output (the
    reference's test, on the port's attention)."""
    base = ModelConfig("b", "dense", 1, 64, 4, 4, 128, 256, d_head=16)
    padded = pad_for_tp(base, 8)
    assert padded.heads == 8
    g = torch.Generator().manual_seed(0)
    p = TL.init_attention(g, base, "cpu")
    pad = {"wq": torch.zeros(64, 8, 16), "wk": torch.zeros(64, 8, 16),
           "wv": torch.zeros(64, 8, 16), "wo": torch.zeros(8, 16, 64)}
    for k in ("wq", "wk", "wv"):
        pad[k][:, :4] = p[k].detach()
    pad["wo"][:4] = p["wo"].detach()
    x = torch.randn((2, 8, 64), generator=g)
    with torch.no_grad():
        np.testing.assert_allclose(
            TL.attention_full(p, x, base).numpy(),
            TL.attention_full(pad, x, padded).numpy(), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def smoke_mesh():
    return PM.make_smoke_mesh("cpu")


def test_smoke_mesh(smoke_mesh):
    assert smoke_mesh.mesh_dim_names == ("data", "model")
    assert tuple(smoke_mesh.mesh.shape) == (1, 1)
    assert PM.make_smoke_mesh("cpu").mesh_dim_names == ("data", "model")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_world_size(smoke_mesh, multi_pod):
    n = 512 if multi_pod else 256
    with pytest.raises(RuntimeError, match=f"world size {n}"):
        PM.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_batch_at_sharding_places_by_spec(smoke_mesh):
    cfg = TD.DataConfig(vocab=256, batch=4, seq=16, seed=3, d_model=8)
    act = PS.activation_specs(PS.DistConfig())
    plain = TD.batch_at(cfg, 2, "cpu")
    got = TD.batch_at(cfg, 2, "cpu", sharding=(smoke_mesh, {
        k: act[k] for k in ("tokens", "labels")}))
    assert set(got) == {"tokens", "labels"}
    for k, v in got.items():
        assert isinstance(v, DTensor)
        assert v.placements == PS.placements(act[k], smoke_mesh)
        assert torch.equal(v.full_tensor(), plain[k])


def test_act_specs_check(smoke_mesh):
    from repro_torch.train.step import check_act_specs
    act = PS.activation_specs(PS.DistConfig())
    check_act_specs({"hidden": act["hidden"], "logits": act["logits"]},
                    smoke_mesh, ("data",))
    with pytest.raises(ValueError, match="tensor parallelism"):
        check_act_specs({"hidden": ("model", None, None)}, smoke_mesh,
                        ("data",))


def test_reshard_rejects_a_model_axis(smoke_mesh):
    cfg = smoke_config("tinyllama-1.1b")
    tr = TLOOP.Trainer(cfg, TLOOP.TrainConfig(batch=2, seq=16,
                                              use_design_advisor=False),
                       device="cpu")
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.zeros(1, 2))
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tr.reshard(mesh, {})


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

SMOKE = "tinyllama-1.1b"


def _steps(params, opt_state, step, data, n=3):
    losses = []
    for s in range(n):
        params, opt_state, loss = step(params, opt_state,
                                       TD.batch_at(data, s, "cpu"))
        losses.append(float(loss))
    return losses


def _named(model):
    return {n: (p.to_local() if isinstance(p, DTensor) else p).detach()
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("compute", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("codec", ["f32", "q8"])
def test_sharded_step_bit_equal_unsharded_and_near_jax(smoke_mesh, compute,
                                                       codec):
    ref_cfg = ref_smoke_config(SMOKE)
    cfg = port_cfg(ref_cfg)
    jp = JM.init_params(jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    opt = AdamWConfig(lr=LR, state_codec=codec)
    data = TD.DataConfig(vocab=cfg.vocab, batch=4, seq=32, seed=1)
    step = make_train_step(cfg, opt, attn_impl="full",
                           grad_compression="q8", compute_dtype=compute)

    plain = interop.params_from_numpy(tree, cfg, device="cpu")
    plain_losses = _steps(plain, adamw_init(plain, opt), step, data)

    sharded = interop.params_from_numpy(tree, cfg, device="cpu")
    specs = PS.param_specs(sharded, cfg, PS.DistConfig(), smoke_mesh)
    state = adamw_init(sharded, opt)
    TLOOP.shard_params(sharded, smoke_mesh, specs, compute_dtype=compute)
    TLOOP.shard_opt_state(state, sharded)
    assert all(isinstance(p, DTensor) for n, p in sharded.named_parameters()
               if n != "final_norm.scale" or compute is None)
    act = PS.activation_specs(PS.DistConfig())
    sharded_step = make_train_step(
        cfg, opt, attn_impl="full", grad_compression="q8",
        compute_dtype=compute,
        act_specs={"hidden": act["hidden"], "logits": act["logits"]})
    got_losses = _steps(sharded, state, sharded_step, data)
    assert got_losses == plain_losses
    got, want = _named(sharded), _named(plain)
    assert all(torch.equal(got[n], want[n]) for n in want)

    jstep = jax.jit(j_make_train_step(
        ref_cfg, JAdamWConfig(lr=LR, state_codec=codec), attn_impl="full",
        grad_compression="q8",
        compute_dtype=None if compute is None else jnp.bfloat16))
    jstate = j_adamw_init(jp, JAdamWConfig(lr=LR, state_codec=codec))
    jdata = JD.DataConfig(vocab=cfg.vocab, batch=4, seq=32, seed=1)
    jlosses = []
    for s in range(3):
        jp, jstate, jloss = jstep(jp, jstate, JD.batch_at(jdata, s))
        jlosses.append(float(jloss))
    rtol = 1e-4 if compute is None else 2e-2
    np.testing.assert_allclose(got_losses, jlosses, rtol=rtol)
    if compute is None:
        d = [np.abs(got[n].numpy() - jl) for n, jl in
             ((n, np.asarray(interop._at(*interop._jax_node(
                 jax.tree.map(np.asarray, jp), n)))) for n in got)]
        assert max(a.max() for a in d) <= 6 * LR
        far = sum(int((a > 1e-5).sum()) for a in d)
        assert far <= 1e-3 * sum(a.size for a in d)


def test_reshard_then_checkpoint_round_trips(smoke_mesh, tmp_path):
    cfg = smoke_config(SMOKE)
    tc = TLOOP.TrainConfig(batch=2, seq=16, steps=2, use_design_advisor=False,
                           checkpoint_dir=str(tmp_path / "ckpt"),
                           checkpoint_every=100)
    tr = TLOOP.Trainer(cfg, tc, device="cpu")
    tr.reshard(smoke_mesh, PS.param_specs(tr.params, cfg, PS.DistConfig(),
                                          smoke_mesh))
    assert tr.n_chips == 1 and tr.mesh is smoke_mesh
    tr.run(2)                                   # saves at step 2
    want = _named(tr.params)
    want_m = {n: {k: (t.to_local() if isinstance(t, DTensor) else t).clone()
                  for k, t in m.items()}
              for n, m in tr.opt_state["moments"].items()}
    with torch.no_grad():
        for p in tr.params.parameters():
            (p.to_local() if isinstance(p, DTensor) else p).zero_()
    step, _, _, _ = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path / "ckpt"))).restore_into(tr.params,
                                                        tr.opt_state)
    assert step == 2
    got = _named(tr.params)
    assert all(torch.equal(got[n], want[n]) for n in want)
    for n, m in tr.opt_state["moments"].items():
        for k, t in m.items():
            assert torch.equal(t.to_local() if isinstance(t, DTensor) else t,
                               want_m[n][k])
