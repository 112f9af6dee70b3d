"""End-to-end training driver on the PyTorch port, with the compression
advisor in the loop, on the card (`--device cpu` for the CPU).

    PYTHONPATH=src python examples/torch_train_e2e.py                # fast
    PYTHONPATH=src python examples/torch_train_e2e.py --preset 100m  # ~100M

The advisor (the paper's technique) picks the physical layout (optimizer-
moment codec, gradient wire codec) from the HBM budget; the trainer
checkpoints atomically (under the temporary directory unless
`--checkpoint-dir` says where) and auto-resumes if re-run.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train.loop import TrainConfig, Trainer

PRESETS = {
    # ~2M params: seconds on the card, a few minutes on CPU
    "fast": (ModelConfig("fast-lm", "dense", 4, 128, 4, 2, 512, 512,
                         d_head=32), TrainConfig(
        steps=120, batch=8, seq=64, lr=3e-3, checkpoint_every=50,
        checkpoint_dir="repro_torch_ckpt_fast", log_every=20)),
    # ~100M params, a few hundred steps (the deliverable driver)
    "100m": (ModelConfig("lm-100m", "dense", 12, 768, 12, 4, 2048, 32000,
                         d_head=64), TrainConfig(
        steps=300, batch=8, seq=256, lr=6e-4, checkpoint_every=100,
        checkpoint_dir="repro_torch_ckpt_100m", log_every=10)),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="fast", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--checkpoint-dir", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, tc = PRESETS[args.preset]
    tc = dataclasses.replace(tc, checkpoint_dir=args.checkpoint_dir or
                             os.path.join(tempfile.gettempdir(),
                                          tc.checkpoint_dir))
    if args.steps:
        tc.steps = args.steps
    print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    trainer = Trainer(cfg, tc, device=dev)
    if trainer.plan:
        print("advisor layout plan:", trainer.plan.choices)
    out = trainer.run()
    print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"over {tc.steps} steps; stragglers flagged: {out['stragglers']}")


if __name__ == "__main__":
    main()
