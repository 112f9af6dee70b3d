"""Roofline report: join the dry run with the analytic census on one H100.

    PYTHONPATH=src python -m repro_torch.launch.report

Counterpart of the JAX package's `launch/report.py`.  Reads
results/dryrun_torch/*.json (`launch/dryrun.py`), computes census-based
roofline terms per cell on the H100's constants (`launch/roofline.py`),
and writes results/roofline_torch.json and the markdown table
results/roofline_torch_table.md.  Where the reference compares a cell's
memory with a TPU v5e chip's 16 GB of HBM, the port compares the dry
run's argument bytes per chip with one card's 80 GB (`fits`).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

from ..configs import ARCHS, get_config
from ..models.config import pad_for_tp
from .census import census
from .roofline import HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS, model_flops
from .specs import SHAPES

RESULTS = Path(__file__).resolve().parents[3] / "results"
MESHES = {"16x16": (256, 1), "2x16x16": (512, 2)}


def _advice(bottleneck: str, cell: Dict) -> str:
    if bottleneck == "collective":
        return ("overlap FSDP all-gathers with layer compute and compress "
                "the gradient all-reduce (q8 wire)")
    if bottleneck == "memory":
        if cell["shape"].startswith(("decode", "long")):
            return "quantize weights/KV (q8/q4) to cut HBM traffic"
        return "recompute less (selective remat) or shrink activations"
    return "increase per-chip arithmetic intensity (larger local batch)"


def cell_report(arch: str, shape: str, mesh: str, dry: Optional[dict],
                variant: str = "baseline", **census_kw) -> Dict:
    cfg = pad_for_tp(get_config(arch), 16)
    info = SHAPES[shape]
    n_chips, pod_dp = MESHES[mesh]
    c = census(cfg, info["kind"], info["batch"], info["seq"], n_chips,
               tp=16, pod_dp=pod_dp, **census_kw)
    t_c = c.flops / PEAK_FLOPS
    t_m = c.hbm_bytes / HBM_BW
    t_w = c.wire_bytes / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_w}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, info) / n_chips
    t_bound = max(terms.values())
    out = {
        "arch": arch, "shape": shape, "mesh": mesh, "variant": variant,
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_w,
        "t_bound_s": t_bound,
        "bottleneck": bottleneck,
        "flops_per_chip": c.flops,
        "hbm_bytes_per_chip": c.hbm_bytes,
        "wire_bytes_per_chip": c.wire_bytes,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": mf / max(c.flops, 1.0),
        "roofline_fraction": (mf / PEAK_FLOPS) / max(t_bound, 1e-12),
        "advice": _advice(bottleneck, {"shape": shape}),
    }
    if dry is not None and dry.get("status") == "ok":
        args = dry["memory"]["argument_bytes"]
        out["memory_args_gb"] = args / 1e9
        out["fits"] = args <= HBM_BYTES
        out["collective_kinds"] = dry.get("collective_counts", {})
        out["dryrun_counts"] = {
            "flops": dry["roofline"]["flops_per_chip"],
            "bytes": dry["roofline"]["hbm_bytes_per_chip"],
            "wire_bytes": dry["roofline"]["wire_bytes_per_chip"],
        }
    return out


def main(results: Path = RESULTS) -> None:
    rows = []
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh in MESHES:
                f = results / "dryrun_torch" / f"{arch}__{shape}__{mesh}.json"
                dry = json.loads(f.read_text()) if f.exists() else None
                if dry is not None and dry["status"] == "skipped":
                    rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                                 "variant": "baseline", "status": "skipped",
                                 "reason": dry["reason"]})
                    continue
                r = cell_report(arch, shape, mesh, dry)
                r["status"] = dry["status"] if dry else "census-only"
                if dry is not None and dry["status"] == "error":
                    r["error"] = dry["error"]
                rows.append(r)
    results.mkdir(parents=True, exist_ok=True)
    (results / "roofline_torch.json").write_text(json.dumps(rows, indent=1))

    # markdown table (single-pod cells only, as the reference's)
    lines = ["| arch | shape | t_comp | t_mem | t_coll | bound | "
             "MF/census | roofline-frac | args GB | dry run |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != "16x16":
            continue
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped (sub-quadratic rule) | — | — | — | "
                         f"skipped |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']*1e3:.1f}ms "
            f"| {r['t_memory_s']*1e3:.1f}ms | {r['t_collective_s']*1e3:.1f}ms "
            f"| {r['bottleneck']} | {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2f} "
            f"| {r.get('memory_args_gb', float('nan')):.1f} "
            f"| {r['status']} |")
    (results / "roofline_torch_table.md").write_text("\n".join(lines))
    print("\n".join(lines))


if __name__ == "__main__":
    main()
