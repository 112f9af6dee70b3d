"""Batched serving on the PyTorch port: continuous batching with per-slot
KV positions, on the card (`--device cpu` for the CPU).

Twin of `serve_batched.py`: requests admitted MID-FLIGHT (while other
slots are decoding) leave in-flight outputs untouched — prefill is
slot-isolated via the `active` mask on `decode_step` — and slots retire
on EOS (`EngineConfig.eos_id`) as well as on `max_new_tokens` and context
overflow.  The weights are random, from `init_params` with seed 0.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""
import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = ModelConfig("serve-demo", "dense", 2, 64, 4, 2, 128, 256, d_head=16)
    params = MD.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)

    eng = ServeEngine(cfg, params, EngineConfig(batch_slots=3, max_len=64),
                      device=dev)
    prompts = [[1, 2, 3], [10, 20], [7, 7, 7, 7], [42], [5, 4, 3, 2, 1],
               [99, 98], [11, 12, 13]]
    # staggered submission: each step admits newcomers into free slots
    # while earlier requests keep decoding — slot isolation guarantees
    # the interleaving is invisible to every request's outputs
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        eng.step()
    eng.run_until_drained()
    print(f"served {len(eng.finished)} requests in {eng.steps} engine steps "
          f"on {eng.ec.batch_slots} slots (admissions interleaved)")
    for uid in sorted(eng.finished):
        r = eng.finished[uid]
        print(f"  req {uid}: prompt {r.prompt} -> {r.out_tokens}")

    # EOS retirement: pick a token request 0 emitted and rerun with it
    # as the stop token — the request retires early, done and untruncated
    eos = eng.finished[0].out_tokens[2]
    eng2 = ServeEngine(cfg, params, EngineConfig(batch_slots=3, max_len=64,
                                                 eos_id=eos), device=dev)
    eng2.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=6))
    eng2.run_until_drained()
    r = eng2.finished[0]
    print(f"with eos_id={eos}: req 0 -> {r.out_tokens} "
          f"(stopped at EOS, truncated={r.truncated})")


if __name__ == "__main__":
    main()
