"""Dry run: count every (arch x shape x mesh) cell's per-chip step without
devices.

Counterpart of the JAX package's `launch/dryrun.py`, which lowers and
compiles each cell for a 256- or 512-device mesh and reads XLA's memory
and cost analyses and the HLO's collectives.  The port has no compiler to
ask, so it counts the same quantities itself, on the `meta` device (shapes
without storage) and from the sharding plan:

* argument bytes per chip, exact: every parameter, AdamW moment, input
  and serving-state tensor at its local shard shape under its spec
  (`distributed.sharding`);
* FLOPs per chip: `torch.utils.flop_counter`'s formulas (`StepCounter`)
  over the cell's step (`make_loss_and_grads` for train, `forward` for prefill,
  `decode_step` for decode) at the local batch, divided by the model
  axis's size (tensor parallelism splits each layer's matmuls) and, where
  the batch does not divide the data axes (sequence parallelism), by
  theirs;
* HBM bytes per chip: operand + result bytes of every op of the same run
  (views excluded), with the same division, plus the AdamW update's reads
  and writes of the local shards in a train cell;
* collectives, leaf by leaf from the plan through `roofline.wire_bytes`:
  FSDP all-gathers of each parameter sharded over the data axes (forward,
  and again in the backward pass when training), gradient reduce-scatters
  over them (all-reduces for a leaf that is not sharded there, and across
  pods), and one all-reduce of the layer's output activation for each use
  of a leaf whose contracting dimension is sharded over the model axis.
  A leaf whose spec fell back to replicated is not counted as sharded.

The layers of a stack are identical, so a step is counted at depth 1 and
2 and the real depth follows exactly; a step with a recurrent scan is
counted at three short lengths and read off their parabola
(`count_step`).

Every cell records `status`: ok, skipped (`cell_supported`) or error with
its reason.  Results go to results/dryrun_torch/<cell>.json.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, get_config
from ..distributed.sharding import (DistConfig, Spec, _rule_key,
                                    axes_size, entry_axes, local_shape)
from ..kernels.quantize_blockwise import DEFAULT_BLOCK
from ..models import model as MD
from ..models.config import ModelConfig, pad_for_tp
from ..models.interop import _split
from ..train.step import make_loss_and_grads, on_wire
from . import roofline as RL
from .mesh import MeshShape, dist_config, mesh_shape
from .specs import (SHAPES, batch_divides, cell_supported, input_specs,
                    model_shardings)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

TP = 16

# rules whose leading (contracting) dimension the model axis shards: each
# use of such a leaf ends in an all-reduce of its output activation
# (tokens x its last dimension) over that axis
ROW_PARALLEL = ("wo_attn", "wo_mlp", "moe_wo", "rwkv_wo", "cm_wv",
                "out_proj", "x_proj", "embed")


class StepCounter(TorchDispatchMode):
    """FLOPs and bytes of every op dispatched under it.

    FLOPs are `torch.utils.flop_counter`'s formulas (`flop_registry`, the
    table `FlopCounterMode` sums: matmuls, convolutions, attention); this
    mode applies them itself because `FlopCounterMode`'s module tracker
    cannot follow `torch.autograd.grad` over leaf tensors, which the train
    step calls.  Bytes are each op's operand + result bytes (view ops move
    nothing and are not counted)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _count(cfg: ModelConfig, kind: str, b: int, s: int,
           kv_dtype) -> Dict[str, float]:
    """FLOPs and op bytes of one step of `cfg` at batch b, sequence (KV
    length for decode) s, on the meta device."""
    param_dtype = torch.float32 if kind == "train" else torch.bfloat16
    model = MD.init_params(torch.Generator(), cfg, "meta").to(param_dtype)
    embeds = None
    if cfg.frontend != "tokens" and kind != "decode":
        embeds = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16,
                             device="meta")
    counter = StepCounter()
    if kind == "decode":
        state = MD.init_serve_state(cfg, b, s, kv_dtype=kv_dtype,
                                    device="meta")
        tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
        with counter:
            MD.decode_step(model, state, cfg, tokens)
    else:
        tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
        with counter:
            if kind == "train":
                make_loss_and_grads(cfg, remat=True,
                                    attn_impl="chunked")(
                    model, {"tokens": tokens, "labels": tokens,
                            "embeds": embeds})
            else:
                with torch.no_grad():
                    MD.forward(model, cfg, tokens, embeds,
                               attn_impl="chunked")
    return {"flops": float(counter.flops), "bytes": float(counter.bytes)}


# sequence lengths at which a step with a recurrent scan (RWKV6, the
# hybrid's Mamba) is counted: each is one scan chunk and one attention
# chunk, where the counts are a polynomial of degree 2 in the length
SEQ_FIT = (32, 64, 96)


def _lagrange(xs, ys, x: float) -> float:
    out = 0.0
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        w = 1.0
        for j, xj in enumerate(xs):
            if j != i:
                w *= (x - xj) / (xi - xj)
        out += w * yi
    return out


def count_step(cfg: ModelConfig, kind: str, b: int, s: int,
               kv_dtype=torch.bfloat16) -> Dict[str, float]:
    """`_count` at the real depth and length.

    The layers of a stack are identical, so the step is counted at depth 1
    and 2 (one and two groups for the hybrid) and the real depth follows
    exactly: c1 + (depth - 1) * (c2 - c1).  A train or prefill step with
    a recurrent scan costs an eager op per time step and layer, so it is
    counted at the lengths `SEQ_FIT` and the real length read off the
    parabola through them: exact for the FLOPs (scans are linear in the
    length, attention's score and value products quadratic; the MoE
    capacity is linear wherever tokens * top_k * capacity_factor / experts
    is whole, as in jamba's cells), and for the bytes up to the online
    softmax's per-chunk bookkeeping, which one chunk does not show."""
    unit = cfg.hybrid.group_size if cfg.hybrid is not None else 1
    depth = cfg.n_layers // unit
    scans = cfg.mixer == "rwkv6" or cfg.hybrid is not None
    lengths = SEQ_FIT if scans and kind != "decode" else (s,)

    def at_depth(length):
        c1, c2 = (_count(dataclasses.replace(cfg, n_layers=unit * k), kind,
                         b, length, kv_dtype) for k in (1, 2))
        return {k: c1[k] + (depth - 1) * (c2[k] - c1[k]) for k in c1}

    counts = [at_depth(n) for n in lengths]
    if len(lengths) == 1:
        return counts[0]
    return {k: _lagrange(lengths, [c[k] for c in counts], s)
            for k in counts[0]}


def _fsdp_entry(spec: Spec, dist: DistConfig) -> Optional[int]:
    """The tensor dimension a spec shards over the data axis, if any."""
    for d, entry in enumerate(spec):
        if dist.data_axis in entry_axes(entry):
            return d
    return None


def plan_collectives(model, specs: Dict[str, Spec], mesh: MeshShape,
                     dist: DistConfig, kind: str, tokens_local: int,
                     grad_compression: Optional[str]) -> RL.CollectiveStats:
    """The step's collectives, leaf by leaf from the sharding plan."""
    col = RL.CollectiveStats()
    train = kind == "train"
    dp_group = axes_size(tuple(dist.dp_axes), mesh)
    pod = mesh.shape.get(dist.pod_axis, 1) if dist.pod_axis else 1
    tp = mesh.shape[dist.tp_axis] if dist.tp_axis else 1
    for name, p in model.named_parameters():
        spec = specs[name]
        local = _numel(local_shape(p.shape, spec, mesh))
        d = _fsdp_entry(spec, dist)
        if d is not None:
            g = axes_size(spec[d], mesh)
            gathered = local * g * 2.0                   # bf16 compute copy
            for _ in range(2 if train else 1):           # fwd (+ bwd)
                col.collective("all-gather", gathered, g)
        if train:
            gbytes = 4.0 * local
            if grad_compression == "q8" and on_wire(p):
                gbytes = local * (1.0 + 4.0 / DEFAULT_BLOCK)
            if d is not None:
                g = axes_size(spec[d], mesh)
                col.collective("reduce-scatter", gbytes, g)
                if pod > 1 and dist.pod_axis not in entry_axes(spec[d]):
                    col.collective("all-reduce", gbytes, pod)
            else:
                col.collective("all-reduce", gbytes, dp_group)
        if (dist.tp_axis is not None
                and _rule_key(_split(name)[0]) in ROW_PARALLEL
                and dist.tp_axis in entry_axes(spec[0])):
            act = tokens_local * p.shape[-1] * 2.0
            for _ in range(3 if train else 1):           # fwd, remat, bwd
                col.collective("all-reduce", act, tp)
    return col


def _sharded_bytes(node, mesh) -> int:
    if isinstance(node, dict):
        return sum(_sharded_bytes(v, mesh) for v in node.values())
    t, spec = node
    return _numel(local_shape(t.shape, spec, mesh)) * t.element_size()


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             opt_codec: str = "f32", kv_dtype=torch.bfloat16,
             grad_compression: Optional[str] = None,
             variant: str = "baseline", parallel_mode: str = "tp",
             kv_seq_shard: bool = False,
             cfg: Optional[ModelConfig] = None) -> dict:
    """One cell's record (`cfg` replaces the arch's configuration, for
    tests at small widths)."""
    base = cfg if cfg is not None else get_config(arch)
    # with seq-sharded KV the kv heads stay logical (no padding waste)
    cfg = pad_for_tp(base, TP, pad_kv=not kv_seq_shard)
    info = SHAPES[shape]
    ok, reason = cell_supported(cfg, shape)
    mesh = mesh_shape(multi_pod=multi_pod)
    result = {"arch": arch, "shape": shape, "mesh": mesh.name,
              "variant": variant, "status": "skipped", "reason": reason}
    if not ok:
        return result

    dist = dist_config(multi_pod=multi_pod, parallel_mode=parallel_mode,
                       kv_seq_shard=kv_seq_shard)
    n_dev = mesh.size
    kind = info["kind"]
    param_dtype = torch.float32 if kind == "train" else torch.bfloat16
    t0 = time.perf_counter()
    model, pspecs = model_shardings(cfg, mesh, dist, param_dtype)
    inputs = input_specs(cfg, shape, mesh, dist, kv_dtype=kv_dtype)

    param_bytes = sum(_numel(local_shape(p.shape, pspecs[n], mesh))
                      * p.element_size()
                      for n, p in model.named_parameters())
    moment_bytes = 0
    if kind == "train":
        for n, p in model.named_parameters():
            ls = local_shape(p.shape, pspecs[n], mesh)
            if opt_codec == "q8":
                nb = -(-ls[-1] // DEFAULT_BLOCK) if ls else 1
                moment_bytes += 2 * (_numel(ls)
                                     + 4 * _numel(ls[:-1]) * nb)
            else:
                moment_bytes += 2 * 4 * _numel(ls)
    input_bytes = _sharded_bytes(inputs, mesh)

    b, s = info["batch"], info["seq"]
    divides = batch_divides(b, mesh, dist)
    dp = axes_size(tuple(dist.dp_axes), mesh)
    b_local = b // dp if divides else b
    tp = mesh.shape[dist.tp_axis] if dist.tp_axis else 1
    split = tp * (1 if divides else dp)
    counted = count_step(cfg, kind, b_local, s, kv_dtype)
    flops_chip = counted["flops"] / split
    hbm_chip = counted["bytes"] / split
    if kind == "train":
        # AdamW: the master parameter read and written, the gradient
        # read, both moments read and written, on the local shards
        hbm_chip += 3 * param_bytes + 2 * moment_bytes
    tokens_local = b_local * (1 if kind == "decode" else s)
    col = plan_collectives(model, pspecs, mesh, dist, kind, tokens_local,
                           grad_compression)
    rl = RL.analyze(flops_chip, hbm_chip, col, n_dev)
    mf = RL.model_flops(cfg, info)
    result.update({
        "status": "ok",
        "n_devices": n_dev,
        "count_s": round(time.perf_counter() - t0, 2),
        "local_batch": b_local,
        "param_count": cfg.param_count(),
        "param_count_padded": cfg.param_count(padded=True),
        "memory": {
            "argument_bytes": param_bytes + moment_bytes + input_bytes,
            "param_bytes": param_bytes,
            "moment_bytes": moment_bytes,
            "input_bytes": input_bytes,
        },
        "roofline": rl.summary(),
        "collective_counts": rl.collectives,
        "collective_bytes": dict(col.bytes_by_kind),
        "model_flops_total": mf,
        "model_flops_per_chip": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / max(rl.flops_per_chip, 1.0),
    })
    return result


def cell_name(arch, shape, multi_pod, variant="baseline"):
    mesh = mesh_shape(multi_pod=multi_pod).name
    v = "" if variant == "baseline" else f"__{variant}"
    return f"{arch}__{shape}__{mesh}{v}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt-codec", default="f32", choices=["f32", "q8"])
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "i8"])
    ap.add_argument("--grad-compression", default=None, choices=[None, "q8"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--parallel", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--kv-seq-shard", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    kv_dtype = torch.bfloat16 if args.kv_dtype == "bf16" else torch.int8
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = cell_name(arch, shape, mp, args.variant)
                out = out_dir / f"{name}.json"
                if out.exists() and not args.force:
                    print(f"[skip cached] {name}")
                    continue
                print(f"[run] {name}", flush=True)
                try:
                    res = run_cell(arch, shape, multi_pod=mp,
                                   opt_codec=args.opt_codec,
                                   kv_dtype=kv_dtype,
                                   grad_compression=args.grad_compression,
                                   variant=args.variant,
                                   parallel_mode=args.parallel,
                                   kv_seq_shard=args.kv_seq_shard)
                except Exception as e:  # noqa: BLE001: record, go on
                    res = {"arch": arch, "shape": shape,
                           "mesh": mesh_shape(multi_pod=mp).name,
                           "variant": args.variant, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                out.write_text(json.dumps(res, indent=2, default=str))
                print(f"  -> {res['status']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
