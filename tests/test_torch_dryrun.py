"""The port's dry run (`repro_torch.launch.dryrun`) and roofline report, on
the CPU.

* `count_step` (depth 1 and 2 extrapolated to the real depth; a step with
  a recurrent scan read off the parabola through three short lengths)
  equals a direct count of the whole step, on the smoke configs;
* a cell's argument bytes equal the local shard bytes its specs give,
  computed here independently; its collectives follow the plan (none on a
  1x1 mesh, one gradient reduce-scatter per FSDP-sharded leaf, fewer wire
  bytes with the q8 wire);
* every family's smoke cells are ok, long_500k skipped for full
  attention; the CLI writes one JSON a cell, records a failing cell as an
  error with its reason and exits 1, and the report joins the dry run with
  the census.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.distributed import sharding as PS
from repro_torch.launch import dryrun as DR
from repro_torch.launch import report as RP
from repro_torch.launch.mesh import MeshShape, dist_config, mesh_shape
from repro_torch.launch.specs import SHAPES, model_shardings
from repro_torch.models.config import pad_for_tp

# every family and shape kind, each long prefill once
CELLS = [(a, sh) for a in ("tinyllama-1.1b", "granite-moe-3b-a800m",
                           "rwkv6-7b", "jamba-1.5-large-398b", "pixtral-12b")
         for sh in ("train_4k", "decode_32k", "long_500k")] + \
    [("tinyllama-1.1b", "prefill_32k"), ("rwkv6-7b", "prefill_32k")]


@pytest.mark.parametrize("arch,kind,s", [
    ("tinyllama-1.1b", "train", 64), ("tinyllama-1.1b", "prefill", 64),
    ("tinyllama-1.1b", "decode", 64), ("granite-moe-3b-a800m", "train", 32),
    ("rwkv6-7b", "train", 128), ("rwkv6-7b", "prefill", 160),
    ("rwkv6-7b", "decode", 16), ("jamba-1.5-large-398b", "prefill", 128)])
def test_count_step_equals_a_direct_count(arch, kind, s):
    cfg = smoke_config(arch)
    unit = cfg.hybrid.group_size if cfg.hybrid is not None else 1
    cfg = dataclasses.replace(cfg, n_layers=(2 if unit > 1 else 3) * unit)
    got = DR.count_step(cfg, kind, 2, s)
    want = DR._count(cfg, kind, 2, s, torch.bfloat16)
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-12)
    assert got["bytes"] == pytest.approx(want["bytes"], rel=1e-12)
    assert want["flops"] > 0


def _local_bytes(model, specs, mesh):
    n = 0
    for name, p in model.named_parameters():
        shape = list(p.shape)
        for d, entry in enumerate(specs[name]):
            for axis in PS.entry_axes(entry):
                shape[d] //= mesh.shape[axis]
        k = 1
        for x in shape:
            k *= x
        n += k * p.element_size()
    return n


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("codec", ["f32", "q8"])
def test_cell_argument_bytes_and_collectives(multi_pod, codec):
    arch = "tinyllama-1.1b"
    cfg = smoke_config(arch)
    rec = DR.run_cell(arch, "train_4k", multi_pod=multi_pod,
                      opt_codec=codec, cfg=cfg)
    assert rec["status"] == "ok"
    mesh = mesh_shape(multi_pod=multi_pod)
    dist = dist_config(multi_pod=multi_pod)
    model, specs = model_shardings(pad_for_tp(cfg, 16), mesh, dist,
                                   torch.float32)
    params = _local_bytes(model, specs, mesh)
    mem = rec["memory"]
    assert mem["param_bytes"] == params
    if codec == "f32":
        assert mem["moment_bytes"] == 2 * params
    b = SHAPES["train_4k"]["batch"] // (32 if multi_pod else 16)
    assert rec["local_batch"] == b
    assert mem["input_bytes"] == 2 * b * 4096 * 4
    assert mem["argument_bytes"] == \
        mem["param_bytes"] + mem["moment_bytes"] + mem["input_bytes"]
    sharded = sum(1 for n in specs
                  if any("data" in PS.entry_axes(e) for e in specs[n]))
    assert rec["collective_counts"]["reduce-scatter"] == sharded
    assert rec["collective_counts"]["all-gather"] == 2 * sharded


def test_plan_collectives_on_one_device_and_with_the_q8_wire():
    cfg = pad_for_tp(smoke_config("tinyllama-1.1b"), 16)
    one = MeshShape(("data", "model"), (1, 1))
    dist = dist_config()
    model, specs = model_shardings(cfg, one, dist, torch.float32)
    col = DR.plan_collectives(model, specs, one, dist, "train", 1024, None)
    assert col.wire_bytes_per_chip == 0 and col.counts == {}
    mesh = mesh_shape()
    model, specs = model_shardings(cfg, mesh, dist, torch.float32)
    f32, q8 = (DR.plan_collectives(model, specs, mesh, dist, "train", 1024,
                                   g) for g in (None, "q8"))
    assert q8.bytes_by_kind["reduce-scatter"] < \
        f32.bytes_by_kind["reduce-scatter"]
    assert q8.bytes_by_kind["all-gather"] == f32.bytes_by_kind["all-gather"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cells_ok_or_skipped(arch, shape):
    cfg = smoke_config(arch)
    rec = DR.run_cell(arch, shape, cfg=cfg)
    full_attention = cfg.family not in ("ssm", "hybrid")
    if shape == "long_500k" and full_attention:
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok"
    rl = rec["roofline"]
    assert rl["flops_per_chip"] > 0 and rl["hbm_bytes_per_chip"] > 0
    assert rl["wire_bytes_per_chip"] > 0


def test_cli_and_report(tmp_path, monkeypatch):
    out = tmp_path / "dryrun_torch"
    assert DR.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                    "--both-meshes", "--out", str(out)]) == 0
    assert DR.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k",
                    "--out", str(out)]) == 0

    def fail(*a, **k):
        raise RuntimeError("no count")
    monkeypatch.setattr(DR, "count_step", fail)
    assert DR.main(["--arch", "yi-9b", "--shape", "decode_32k",
                    "--out", str(out)]) == 1
    recs = {f.stem: json.loads(f.read_text()) for f in out.glob("*.json")}
    assert recs["tinyllama-1.1b__decode_32k__16x16"]["status"] == "ok"
    assert recs["tinyllama-1.1b__decode_32k__2x16x16"]["status"] == "ok"
    assert recs["tinyllama-1.1b__long_500k__16x16"]["status"] == "skipped"
    bad = recs["yi-9b__decode_32k__16x16"]
    assert bad["status"] == "error" and "no count" in bad["error"]

    RP.main(tmp_path)
    rows = json.loads((tmp_path / "roofline_torch.json").read_text())
    assert len(rows) == len(ARCHS) * len(SHAPES) * 2
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    ok = by[("tinyllama-1.1b", "decode_32k", "16x16")]
    assert ok["status"] == "ok" and ok["fits"]
    assert ok["dryrun_counts"]["flops"] > 0
    assert by[("yi-9b", "decode_32k", "16x16")]["status"] == "error"
    assert by[("yi-9b", "train_4k", "16x16")]["status"] == "census-only"
    assert (tmp_path / "roofline_torch_table.md").read_text().startswith(
        "| arch |")
