"""The port's analytic census and roofline against the JAX package's, on
the CPU.

* `census` equals the reference's field by field (FLOPs, HBM bytes, wire
  bytes and every detail entry) in every (arch x shape x mesh) cell of
  the dry run, and with the gradient wire, remat off and a KV dtype;
* `roofline.wire_bytes` gives, per collective kind and group size, what
  the reference's `parse_collectives` reads off a synthetic HLO line;
* the reference's `TestCensusValidation` cases, with the census's forward
  FLOPs held to `torch.utils.flop_counter.FlopCounterMode` over the port's
  forward (the reference holds them to XLA's `cost_analysis` of an
  unrolled layer stack) at the same 15 % (dense) and 30 % (MoE).
"""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.launch import census as RC
from repro.launch import roofline as RR
from repro.launch.specs import SHAPES as REF_SHAPES
from repro.models.config import pad_for_tp as ref_pad_for_tp
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import census as PC
from repro_torch.launch import roofline as PR
from repro_torch.launch.specs import SHAPES
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig, MoEConfig, pad_for_tp

MESHES = {"16x16": (256, 1), "2x16x16": (512, 2)}


def test_shapes_are_the_reference_shapes():
    assert SHAPES == REF_SHAPES


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kw", [{}, {"grad_compression": "q8"},
                                {"remat": False},
                                {"kv_bytes_per_elem": 1.0}],
                         ids=["base", "q8", "noremat", "kv8"])
def test_census_equals_reference(arch, shape, mesh, kw):
    info = SHAPES[shape]
    n_chips, pod_dp = MESHES[mesh]
    args = (info["kind"], info["batch"], info["seq"], n_chips)
    got = PC.census(pad_for_tp(get_config(arch), 16), *args, tp=16,
                    pod_dp=pod_dp, **kw)
    want = RC.census(ref_pad_for_tp(ref_get_config(arch), 16), *args,
                     tp=16, pod_dp=pod_dp, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_flops_equal_reference(arch, shape):
    assert PR.model_flops(get_config(arch), SHAPES[shape]) == \
        RR.model_flops(ref_get_config(arch), REF_SHAPES[shape])


def _hlo(kind, shape, groups):
    return (f"  %x.1 = {shape} {kind}(f32[8]{{0}} %p), "
            f"replica_groups={groups}, to_apply=%add")


@pytest.mark.parametrize("kind", PR.KINDS)
@pytest.mark.parametrize("group", [1, 2, 4, 16, 256])
@pytest.mark.parametrize("shape,nbytes", [("f32[1024,16]{1,0}", 65536),
                                          ("bf16[4096]{0}", 8192),
                                          ("s8[3,5]{1,0}", 15)])
def test_wire_bytes_match_reference_hlo_parser(kind, group, shape, nbytes):
    line = _hlo(kind, shape, "{{" + ",".join(map(str, range(group))) + "}}")
    stats = RR.parse_collectives(line, n_devices=group)
    got = PR.wire_bytes(kind, nbytes, group)
    assert got == stats.wire_bytes_per_chip
    col = PR.CollectiveStats()
    col.collective(kind, nbytes, group)
    assert col.counts == stats.counts
    assert col.wire_bytes_per_chip == stats.wire_bytes_per_chip


def test_wire_bytes_match_iota_groups():
    line = _hlo("all-reduce", "f32[64]{0}", "[4,8]<=[32]")
    stats = RR.parse_collectives(line, n_devices=32)
    assert PR.wire_bytes("all-reduce", 256, 8) == stats.wire_bytes_per_chip


def test_analyze_builds_the_roofline():
    col = PR.CollectiveStats()
    col.collective("all-gather", 1e9, 16)
    rl = PR.analyze(2e12, 1e9, col, 256)
    assert rl.t_compute == 2e12 / PR.PEAK_FLOPS
    assert rl.t_memory == 1e9 / PR.HBM_BW
    assert rl.t_collective == 1e9 * 15 / 16 / PR.LINK_BW
    assert rl.t_bound == max(rl.t_compute, rl.t_memory, rl.t_collective)
    assert rl.collectives == {"all-gather": 1}
    assert rl.summary()["bottleneck"] == rl.bottleneck


# ---------------------------------------------------------------------------
# TestCensusValidation, against FlopCounterMode
# ---------------------------------------------------------------------------

def _fwd_flops_counted(cfg, b, s):
    model = TM.init_params(torch.Generator(), cfg, "meta")
    toks = torch.empty((b, s), dtype=torch.int32, device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        TM.forward(model, cfg, toks, attn_impl="full")
    return float(counter.get_total_flops())


@pytest.mark.parametrize("layers,d,heads,kv,ff", [
    (2, 128, 4, 2, 256), (4, 256, 8, 4, 512)])
def test_dense_forward_matches_counted(layers, d, heads, kv, ff):
    cfg = ModelConfig("t", "dense", layers, d, heads, kv, ff, 512,
                      d_head=d // heads)
    b, s = 2, 128
    counted = _fwd_flops_counted(cfg, b, s)
    analytic = sum(PC.forward_flops(cfg, b, s, s, False).values())
    assert abs(analytic / counted - 1) < 0.15, \
        f"census {analytic:.3e} vs counted {counted:.3e}"


def test_moe_forward_matches_counted():
    cfg = ModelConfig("t", "moe", 2, 128, 4, 2, 256, 512, d_head=32,
                      moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=128,
                                    capacity_factor=1.25))
    b, s = 2, 128
    counted = _fwd_flops_counted(cfg, b, s)
    analytic = sum(PC.forward_flops(cfg, b, s, s, False).values())
    # MoE dispatch gather/scatter adds non-matmul flops; allow 30%
    assert abs(analytic / counted - 1) < 0.30


def test_train_flops_factor():
    """Train census ~= 4x forward (bwd 2x + remat recompute 1x)."""
    cfg = ModelConfig("t", "dense", 2, 128, 4, 2, 256, 512, d_head=32)
    c = PC.census(cfg, "train", 4, 128, n_chips=1, tp=1)
    f = sum(PC.forward_flops(cfg, 4, 128, 128, False).values())
    assert 3.5 * f < c.flops < 4.6 * f


def test_decode_flops_scale_with_batch_not_seq():
    cfg = ModelConfig("t", "dense", 2, 128, 4, 2, 256, 512, d_head=32)
    a = PC.census(cfg, "decode", 8, 1024, n_chips=1, tp=1)
    b = PC.census(cfg, "decode", 16, 1024, n_chips=1, tp=1)
    assert 1.8 < b.flops / a.flops < 2.2


def test_collectives_zero_on_single_chip():
    cfg = ModelConfig("t", "dense", 2, 128, 4, 2, 256, 512, d_head=32)
    c = PC.census(cfg, "train", 4, 128, n_chips=1, tp=1)
    assert c.wire_bytes == 0.0


def test_grad_compression_cuts_wire_bytes():
    cfg = ModelConfig("t", "dense", 2, 128, 4, 2, 256, 512, d_head=32)
    a = PC.census(cfg, "train", 64, 128, n_chips=256, tp=16)
    b = PC.census(cfg, "train", 64, 128, n_chips=256, tp=16,
                  grad_compression="q8")
    assert b.wire_bytes < a.wire_bytes  # int8 gradients on the wire
