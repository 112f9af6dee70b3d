"""The paper's technique as a framework feature, on the PyTorch port: ask
the tensor physical-design advisor for a layout plan per (arch x job x
HBM budget).  The planner is host arithmetic; `--device` is checked as
every twin checks it (`--device cpu` for a host without a card).

    PYTHONPATH=src python examples/torch_layout_advisor.py \
        --arch jamba-1.5-large-398b
"""
import argparse

from repro_torch.configs import ARCHS, get_config
from repro_torch.design import plan_layout
from repro_torch.device import resolve_device
from repro_torch.models.config import pad_for_tp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-1.5-large-398b", choices=ARCHS)
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg = pad_for_tp(get_config(args.arch), 16)
    print(f"{cfg.name}: {cfg.param_count()/1e9:.1f}B params on "
          f"{args.chips} chips")
    for kind, b, s in (("train", 256, 4096), ("serve", 128, 32768)):
        flops = (6.0 if kind == "train" else 2.0) * cfg.param_count() \
            * (b * s if kind == "train" else b) / args.chips
        for budget in (8e9, 16e9, 64e9):
            plan = plan_layout(cfg, kind, b, s, args.chips, budget,
                               base_flops_per_chip=flops)
            fit = "fits" if plan.hbm_bytes <= budget else "INFEASIBLE"
            print(f"  {kind:5s} @ {budget/1e9:4.0f}GB: {plan.choices} "
                  f"-> {plan.hbm_bytes/1e9:5.1f}GB ({fit})")


if __name__ == "__main__":
    main()
