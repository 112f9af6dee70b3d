"""The port's checkpoint (`repro_torch.checkpoint`) and host codecs
(`repro_torch.design.codecs`) against the JAX package, on the CPU.

Twins of `tests/test_runtime.py::TestCheckpoint` (round trip,
keep_last_k, checksum, compression shrinks, async, no `.tmp` left) and of
its codec tests (SampleCF accuracy, a round trip over every codec, the
port's `zlib` and `q8+zlib` included), then the two packages side by
side on the same state (a JAX `init_params` after two eager AdamW updates
of seeded NumPy gradients, carried into the port with
`models.interop`):

* configured with the reference's codecs (`zstd` / `q8+zstd` and
  `raw+zstd`), the port's step directory is byte-identical, file by file,
  to the JAX `CheckpointManager`'s, with float32 and with q8 moments;
* each package's `restore_into` reads the other's directory bit-exactly;
* `encode` payloads equal the reference's for f32, bf16, q8, zstd and
  q8+zstd, and `sample_cf_bytes("zstd")` equals the reference's number;
* an async save keeps the values of its step while a training step
  updates the parameters in place.

Every comparison is exact: the codecs are lossless, and q8 is the same
IEEE arithmetic in both packages (`tests/test_torch_quantize.py`).
"""
import dataclasses
import json
import os
import sys
import threading
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch import nn

from repro.checkpoint.manager import CheckpointConfig as JCheckpointConfig
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.design import codecs as JC
from repro.models import model as JM
from repro.models.config import ModelConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch import design
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.checkpoint import manager as TMAN
from repro_torch.design import codecs as TC
from repro_torch.kernels.quantize_blockwise import (
    dequantize_blockwise_plain, quantize_blockwise_plain)
from repro_torch.models import interop
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as PortModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

TINY = ModelConfig("tiny", "dense", 2, 64, 4, 2, 128, 256, d_head=16)
# last dimensions off the 128-element quantization block: ragged blocks
ODD = ModelConfig("odd", "dense", 2, 96, 4, 2, 200, 300, d_head=24)
REF_CODECS = dict(moments_codec="zstd", raw_codec="raw+zstd")


def port_cfg(cfg):
    return PortModelConfig(**dataclasses.asdict(cfg))


class Leaves(nn.Module):
    """Named tensors as a module's parameters: the port's twin of the
    reference tests' `{"w": ...}` trees."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))


def bits(t):
    t = torch.as_tensor(t)
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.contiguous().view(view[t.dtype]) if t.dtype in view else t


def assert_bit_equal(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(bits(a), bits(b))


def jax_state(cfg, codec, seed=0):
    """A JAX `init_params` tree and an AdamW state after two eager updates
    of seeded NumPy gradients."""
    params = JM.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    ocfg = JAdamWConfig(state_codec=codec)
    state = j_adamw_init(params, ocfg)
    rng = np.random.default_rng(seed)
    for _ in range(2):
        grads = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), params)
        params, state = j_adamw_update(params, grads, state, ocfg)
    return params, state


def carried(params, state, cfg):
    np_p = jax.tree.map(np.asarray, params)
    tp = interop.params_from_numpy(np_p, port_cfg(cfg), device="cpu")
    ts = interop.opt_state_from_numpy(jax.tree.map(np.asarray, state), tp,
                                      "cpu")
    return tp, ts


def port_model(cfg=TINY, seed=0):
    return TM.init_params(torch.Generator().manual_seed(seed),
                          port_cfg(cfg), "cpu")


def state_tensors(params, opt_state=None):
    """{key: [tensors]} of the checkpoint's leaves, for comparisons."""
    return {k: ts for k, (_, ts) in
            interop.checkpoint_leaves(params, opt_state).items()}


def assert_states_equal(a_params, a_opt, b_params, b_opt):
    a, b = state_tensors(a_params, a_opt), state_tensors(b_params, b_opt)
    assert list(a) == list(b)
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert_bit_equal(x.detach(), y.detach())


def step_dir(mgr):
    return next(p for p in sorted(Path(mgr.dir).glob("step_*")))


# ---------------------------------------------------------------------------
# twins of tests/test_runtime.py::TestCheckpoint
# ---------------------------------------------------------------------------

def _mgr(tmp_path, **kw):
    return CheckpointManager(CheckpointConfig(str(tmp_path / "ck"), **kw))


@pytest.mark.parametrize("codec", ["f32", "q8"])
def test_roundtrip(tmp_path, codec):
    mgr = _mgr(tmp_path)
    params = port_model()
    opt = adamw_init(params, AdamWConfig(state_codec=codec))
    mgr.save(10, params, opt)
    fresh = port_model(seed=1)
    fresh_opt = adamw_init(fresh, AdamWConfig(state_codec=codec))
    fresh_opt["step"] = torch.tensor(5, dtype=torch.int32)
    step, got, got_opt, _ = mgr.restore_into(fresh, fresh_opt)
    assert step == 10 and got is fresh and got_opt is fresh_opt
    assert_states_equal(params, opt, fresh, fresh_opt)
    assert fresh_opt["step"].dtype == torch.int32


def test_keep_last_k(tmp_path):
    mgr = _mgr(tmp_path, keep_last_k=2)
    params = Leaves(w=torch.ones((8, 8)))
    for s in (1, 2, 3, 4):
        mgr.save(s, params)
    dirs = sorted(Path(mgr.dir).glob("step_*"))
    assert [d.name for d in dirs] == ["step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4


@pytest.mark.parametrize("how", ["restore", "restore_into"])
def test_checksum_detects_corruption(tmp_path, how):
    mgr = _mgr(tmp_path)
    params = Leaves(a=torch.ones(4), w=torch.arange(1024.0))
    mgr.save(1, params)
    d = step_dir(mgr)
    f = d / "leaf_00001.bin"
    raw = bytearray(f.read_bytes())
    raw[0] ^= 0xFF
    f.write_bytes(bytes(raw))
    template = Leaves(a=torch.zeros(4), w=torch.zeros(1024))
    with pytest.raises(IOError, match="checksum"):
        if how == "restore":
            mgr.restore()
        else:
            mgr.restore_into(template)
    # every payload is checked before any template tensor is written
    assert not template.a.any() and not template.w.any()


def test_compression_actually_shrinks(tmp_path):
    mgr = _mgr(tmp_path)
    # structured data compresses well under zlib
    w = torch.arange(128.0).tile((256, 1))
    mgr.save(1, Leaves(w=w))
    man = json.loads((step_dir(mgr) / "manifest.json").read_text())
    leaf = list(man["leaves"].values())[0]
    assert leaf["codec"] == "zlib"
    assert leaf["stored_bytes"] < 0.5 * leaf["raw_bytes"]


def test_async_save(tmp_path):
    mgr = _mgr(tmp_path, async_save=True)
    mgr.save(5, Leaves(w=torch.ones((64, 64))))
    mgr.wait()
    assert mgr.latest_step() == 5


def test_atomic_no_tmp_left(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, Leaves(w=torch.ones((4,))))
    assert not list(Path(mgr.dir).glob("*.tmp"))


# ---------------------------------------------------------------------------
# the port's own checks
# ---------------------------------------------------------------------------

def test_async_snapshot_survives_an_in_place_step(tmp_path, monkeypatch):
    """save() copies to the host before it returns: a training step that
    updates the parameters in place before the write runs changes nothing
    in the checkpoint."""
    gate = threading.Event()
    write = CheckpointManager._write

    def gated(self, *args):
        assert gate.wait(timeout=60)
        return write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", gated)
    mgr = _mgr(tmp_path, async_save=True)
    params = port_model()
    ocfg = AdamWConfig(state_codec="q8")
    opt = adamw_init(params, ocfg)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    mgr.save(1, params, opt)
    grads = {n: torch.randn(p.shape, generator=torch.Generator()
                            .manual_seed(i))
             for i, (n, p) in enumerate(params.named_parameters())}
    adamw_update(params, grads, opt, ocfg)
    assert all(not torch.equal(before[n], p)
               for n, p in params.named_parameters())
    gate.set()          # the write runs only now, after the step
    mgr.wait()
    fresh = port_model(seed=1)
    mgr.restore_into(fresh, adamw_init(fresh, ocfg))
    for n, p in fresh.named_parameters():
        assert_bit_equal(p.detach(), before[n])


def test_async_save_raises_on_wait(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path, async_save=True)

    def broken(leaf):
        raise OSError("disk full")

    monkeypatch.setattr(CheckpointManager, "_encode", staticmethod(broken))
    mgr.save(1, Leaves(w=torch.ones(4)))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_restore_into_rejects_a_shape_that_does_not_fit(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, port_model(TINY))
    bigger = TM.init_params(torch.Generator().manual_seed(0), port_cfg(
        dataclasses.replace(TINY, d_ff=256)), "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore_into(bigger)
    deeper = TM.init_params(torch.Generator().manual_seed(0), port_cfg(
        dataclasses.replace(TINY, n_layers=3)), "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore_into(deeper)


def test_restore_into_needs_every_leaf(tmp_path):
    mgr = _mgr(tmp_path)
    params = port_model()
    mgr.save(1, params)
    with pytest.raises(KeyError, match="opt_state/moments"):
        mgr.restore_into(params, adamw_init(params, AdamWConfig()))


def test_restore_returns_cpu_tensors_under_the_reference_keys(tmp_path):
    mgr = _mgr(tmp_path)
    params = port_model()
    opt = adamw_init(params, AdamWConfig(state_codec="q8"))
    mgr.save(3, params, opt, extra={"loss": 2.5})
    step, flat, extra = mgr.restore()
    assert step == 3 and extra == {"loss": 2.5}
    assert "params/layers/attn/wq" in flat
    assert "opt_state/moments/layers/mlp/wi/m_q" in flat
    assert flat["opt_state/step"].dtype == torch.int32
    assert flat["opt_state/step"].shape == ()
    wq = torch.stack([layer["attn"]["wq"].detach()
                      for layer in params.layers])
    assert_bit_equal(flat["params/layers/attn/wq"], wq)
    assert all(t.device.type == "cpu" for t in flat.values())


def test_restore_an_older_step(tmp_path):
    mgr = _mgr(tmp_path, keep_last_k=3)
    for s in (1, 2):
        mgr.save(s, Leaves(w=torch.full((3,), float(s))))
    _, flat, _ = mgr.restore(1)
    assert flat["params/w"].tolist() == [1.0, 1.0, 1.0]
    with pytest.raises(FileNotFoundError):
        _mgr(tmp_path / "empty").restore()


def test_bf16_and_integer_leaves_are_raw(tmp_path):
    mgr = _mgr(tmp_path)
    g = torch.Generator().manual_seed(0)
    src = Leaves(h=torch.randn((3, 130), generator=g).to(torch.bfloat16),
                 i=torch.arange(-5, 5, dtype=torch.int32))
    mgr.save(1, src)
    metas = json.loads((step_dir(mgr) / "manifest.json").read_text())
    assert {m["codec"] for m in metas["leaves"].values()} == {"raw+zlib"}
    assert metas["leaves"]["params/h"]["dtype"] == "bfloat16"
    dst = Leaves(h=torch.zeros((3, 130), dtype=torch.bfloat16),
                 i=torch.zeros(10, dtype=torch.int32))
    mgr.restore_into(dst)
    assert_bit_equal(dst.h.detach(), src.h.detach())
    assert_bit_equal(dst.i.detach(), src.i.detach())
    assert mgr.restore()[1]["params/h"].dtype == torch.bfloat16


@pytest.mark.parametrize("codec", ["q8", "q8+zlib"])
def test_q8_save_quantizes_in_one_grouped_call(tmp_path, monkeypatch,
                                               codec):
    calls = {"quantize": 0, "dequantize": 0}
    for name, key in (("quantize_blockwise_group", "quantize"),
                      ("dequantize_blockwise_group", "dequantize")):
        real = getattr(TMAN, name)

        def counting(items, *a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(items, *a, **kw)

        monkeypatch.setattr(TMAN, name, counting)
    mgr = _mgr(tmp_path, params_codec=codec)
    params = port_model(ODD)
    mgr.save(1, params)
    fresh = port_model(ODD, seed=1)
    mgr.restore_into(fresh)
    assert calls == {"quantize": 1, "dequantize": 1}
    for (n, p), f in zip(params.named_parameters(), fresh.parameters()):
        want = dequantize_blockwise_plain(*quantize_blockwise_plain(p))
        assert_bit_equal(f.detach(), want)


def test_config_rejects_unknown_codecs(tmp_path):
    with pytest.raises(ValueError, match="unknown codec"):
        _mgr(tmp_path, params_codec="lz4")
    with pytest.raises(ValueError, match="raw_codec"):
        _mgr(tmp_path, raw_codec="zlib")


def test_zstd_without_zstandard_raises(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path, **REF_CODECS, params_codec="zstd")
    params = port_model()
    mgr.save(1, params, adamw_init(params, AdamWConfig()))
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        mgr.restore()
    with pytest.raises(ImportError, match="zstandard"):
        TC.encode("q8+zstd", torch.ones((2, 8)))
    with pytest.raises(ImportError, match="zstandard"):
        _mgr(tmp_path / "b", params_codec="zstd").save(1, params)
    # the zlib codecs need no zstandard
    payload, meta = TC.encode("q8+zlib", torch.ones((2, 8)))
    assert torch.equal(TC.decode(payload, meta, "cpu"), torch.ones((2, 8)))


# ---------------------------------------------------------------------------
# codecs: twins of the reference's codec tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["zstd", "zlib"])
def test_samplecf_accuracy(name):
    rng = np.random.default_rng(0)
    # compressible: low-entropy rows
    arr = torch.from_numpy(np.repeat(rng.integers(0, 8, (4096, 1)), 64,
                                     axis=1).astype(np.float32))
    est = design.sample_cf_bytes(name, arr, fraction=0.1)
    true = len(design.encode(name, arr)[0])
    assert abs(est / true - 1) < 0.5


@given(st.sampled_from(TC.HOST_CODECS))
@settings(max_examples=14, deadline=None)
def test_property_codec_roundtrip(name):
    rng = np.random.default_rng(1)
    arr = torch.from_numpy(rng.standard_normal((32, 128)).astype(
        np.float32))
    payload, meta = design.encode(name, arr)
    out = design.decode(payload, meta, device="cpu")
    assert out.shape == arr.shape and out.dtype == torch.float32
    if name in ("f32", "zstd", "zlib"):
        assert_bit_equal(out, arr)
    else:
        tol = 0.05 if name.startswith("q8") else 0.01
        assert (out - arr).abs().max() < tol * arr.abs().max() + 0.05
    if name.startswith("q8"):
        want = dequantize_blockwise_plain(*quantize_blockwise_plain(arr))
        assert_bit_equal(out, want)


def test_codecs_keep_the_reference_catalogue():
    assert TC.CODECS == {k: TC.Codec(**dataclasses.asdict(v))
                         for k, v in JC.CODECS.items()}
    assert set(TC.HOST_CODECS) - set(TC.CODECS) == {"zlib", "q8+zlib"}


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16", "q8", "zstd", "q8+zstd"])
@pytest.mark.parametrize("shape", [(32, 128), (3, 7, 200), (300,)])
def test_encode_payload_equals_reference(name, shape):
    arr = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    j_payload, j_meta = JC.encode(name, arr)
    t_payload, t_meta = TC.encode(name, torch.from_numpy(arr))
    assert t_payload == j_payload and t_meta == j_meta
    want = JC.decode(j_payload, j_meta)
    assert_bit_equal(TC.decode(t_payload, t_meta, "cpu"),
                     torch.from_numpy(np.array(want, np.float32)))


@pytest.mark.parametrize("fraction,seed", [(0.05, 0), (0.1, 3)])
def test_sample_cf_bytes_equals_reference(fraction, seed):
    rng = np.random.default_rng(4)
    arr = (rng.standard_normal((512, 96)) * 0.02).astype(np.float32)
    for name in ("zstd", "q8+zstd", "f32"):
        want = JC.sample_cf_bytes(name, arr, fraction, seed)
        got = TC.sample_cf_bytes(name, torch.from_numpy(arr), fraction, seed)
        assert got == want


@pytest.mark.parametrize("cfg", [TINY, ODD], ids=["tiny", "odd"])
@pytest.mark.parametrize("codec", ["f32", "q8"])
def test_opt_state_to_numpy_inverts_from_numpy(cfg, codec):
    params, state = jax_state(cfg, codec)
    tp, ts = carried(params, state, cfg)
    back = interop.opt_state_to_numpy(ts, tp)
    tree = jax.tree.map(np.asarray, state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert back["step"].dtype == np.int32


@pytest.mark.parametrize("codec", ["f32", "q8"])
@pytest.mark.parametrize("params_codec", ["zstd", "q8+zstd"])
def test_step_directory_byte_identical_to_reference(tmp_path, codec,
                                                    params_codec):
    params, state = jax_state(TINY, codec)
    tp, ts = carried(params, state, TINY)
    JCheckpointManager(JCheckpointConfig(
        str(tmp_path / "jax"), params_codec=params_codec)).save(
            7, params, state, extra={"loss": 1.5})
    CheckpointManager(CheckpointConfig(
        str(tmp_path / "port"), params_codec=params_codec,
        **REF_CODECS)).save(7, tp, ts, extra={"loss": 1.5})
    a, b = tmp_path / "jax" / "step_00000007", tmp_path / "port" / \
        "step_00000007"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert len(names) == 1 + len(jax.tree.leaves(params)) + \
        len(jax.tree.leaves(state))
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_bf16_leaf_byte_identical_to_reference(tmp_path):
    arr = np.random.default_rng(5).standard_normal((4, 9)).astype(
        np.float32)
    JCheckpointManager(JCheckpointConfig(str(tmp_path / "jax"))).save(
        2, {"h": jnp.asarray(arr).astype(jnp.bfloat16),
            "i": jnp.arange(6, dtype=jnp.int32)})
    CheckpointManager(CheckpointConfig(str(tmp_path / "port"),
                                       **REF_CODECS)).save(
        2, Leaves(h=torch.from_numpy(arr).to(torch.bfloat16),
                  i=torch.arange(6, dtype=torch.int32)))
    for n in ("manifest.json", "leaf_00000.bin", "leaf_00001.bin"):
        assert (tmp_path / "jax" / "step_00000002" / n).read_bytes() == \
            (tmp_path / "port" / "step_00000002" / n).read_bytes()


@pytest.mark.parametrize("codec", ["f32", "q8"])
def test_each_package_restores_the_others_checkpoint(tmp_path, codec):
    params, state = jax_state(TINY, codec)
    tp, ts = carried(params, state, TINY)
    JCheckpointManager(JCheckpointConfig(str(tmp_path / "jax"))).save(
        4, params, state)
    CheckpointManager(CheckpointConfig(str(tmp_path / "port"),
                                       params_codec="zstd",
                                       **REF_CODECS)).save(4, tp, ts)
    # the JAX manager reads the port's directory
    zeros_p = jax.tree.map(jnp.zeros_like, params)
    zeros_s = jax.tree.map(jnp.zeros_like, state)
    step, jp, js, _ = JCheckpointManager(JCheckpointConfig(
        str(tmp_path / "port"))).restore_into(zeros_p, zeros_s)
    assert step == 4
    for got, want in ((jp, params), (js, state)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        jax.tree.map(lambda g, w: np.testing.assert_array_equal(
            np.asarray(g), np.asarray(w)), got, want)
    # the port's manager reads the JAX directory
    fresh = port_model(seed=1)
    fresh_opt = adamw_init(fresh, AdamWConfig(state_codec=codec))
    step, _, _, _ = CheckpointManager(CheckpointConfig(
        str(tmp_path / "jax"))).restore_into(fresh, fresh_opt)
    assert step == 4
    assert_states_equal(fresh, fresh_opt, tp, ts)


def test_port_zlib_checkpoint_reads_back_through_restore(tmp_path):
    """The default codecs (zlib): restore() gives the JAX tree's leaves,
    equal to the reference's flat restore of its own zstd checkpoint."""
    params, state = jax_state(TINY, "q8")
    tp, ts = carried(params, state, TINY)
    JCheckpointManager(JCheckpointConfig(str(tmp_path / "jax"))).save(
        1, params, state)
    CheckpointManager(CheckpointConfig(str(tmp_path / "port"))).save(
        1, tp, ts)
    _, want, _ = JCheckpointManager(JCheckpointConfig(
        str(tmp_path / "jax"))).restore()
    _, got, _ = CheckpointManager(CheckpointConfig(
        str(tmp_path / "port"))).restore()
    assert sorted(got) == sorted(want)
    for k in want:
        assert_bit_equal(got[k], torch.from_numpy(np.array(want[k])))
    metas = json.loads((tmp_path / "port" / "step_00000001" /
                        "manifest.json").read_text())["leaves"]
    assert {m["codec"] for m in metas.values()} == {"zlib", "raw+zlib"}
    for k, m in metas.items():
        payload = (tmp_path / "port" / "step_00000001" / m["file"]
                   ).read_bytes()
        assert zlib.crc32(payload) == m["crc32"]
