"""Training launcher: --arch <id> selects any assigned architecture.

Trains the reduced (smoke) variant of the chosen arch by default; --full
uses the published config.  Runs on the card unless --device cpu is
given; with --checkpoint-dir it resumes from the latest checkpoint there
and checkpoints as it goes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 50 --checkpoint-dir ckpt

Counterpart of the JAX package's `launch/train.py`; `--hbm-budget-gb`
defaults to one H100's 80 GB (the JAX launcher's 16 is a TPU v5e chip's),
and `--device` is the one flag it adds (the JAX trainer takes no device).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..configs import ARCHS, get_config, smoke_config
from ..train.loop import TrainConfig, Trainer


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse `argv` (the command line when None), train, and return the
    trainer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="use the published config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--hbm-budget-gb", type=float, default=80.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    tc = TrainConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                     lr=args.lr, checkpoint_dir=args.checkpoint_dir,
                     hbm_budget_bytes=args.hbm_budget_gb * 1e9)
    print(f"[launch] {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    trainer = Trainer(cfg, tc, device=args.device)
    if trainer.plan is not None:
        print(f"[launch] advisor layout: {trainer.plan.choices}")
    out = trainer.run()
    print(f"[launch] loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}")
    return trainer


if __name__ == "__main__":
    main()
