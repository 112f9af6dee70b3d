"""Deterministic synthetic token pipeline.

batch_at(step) is a PURE function of (seed, step): no iterator state to
checkpoint, and a restart gets the same batches.

The synthetic language is learnable: with probability ~7/8 the next token
is an affine function of the current one, else it re-seeds, so training
loss falls measurably within a few steps.

Counterpart of the JAX package's `data/pipeline.py`: the same NumPy
generator gives the same tokens and labels, returned as int32 tensors on
the port's device (the card unless the caller asks for the CPU), and the
stub embeddings of the vlm / audio frontends (`d_model` > 0) with JAX's
bfloat16 bits.  With `sharding` (a mesh and activation specs), each
batch tensor becomes a `DTensor` on the mesh, placed by its spec.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from ..device import resolve_tensor_device
from ..distributed.sharding import placements


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    d_model: int = 0        # >0 => also emit stub embeddings (vlm/audio)


def _tokens_for(cfg: DataConfig, step: int) -> np.ndarray:
    rng = np.random.default_rng((cfg.seed * 1_000_003 + step) & 0x7FFFFFFF)
    b, s, v = cfg.batch, cfg.seq, cfg.vocab
    start = rng.integers(0, v, size=(b, 1))
    noise = rng.random((b, s)) < 0.125
    fresh = rng.integers(0, v, size=(b, s))
    toks = np.empty((b, s), np.int64)
    toks[:, 0] = start[:, 0]
    a, c = 31, 7
    for i in range(1, s):
        nxt = (toks[:, i - 1] * a + c) % v
        toks[:, i] = np.where(noise[:, i], fresh[:, i], nxt)
    return toks.astype(np.int32)


def batch_at(cfg: DataConfig, step: int, device="cuda",
             sharding: Optional[Tuple[object, Mapping]] = None
             ) -> Dict[str, torch.Tensor]:
    """Batch for `step`: tokens and next-token labels, (batch, seq) int32,
    and with `cfg.d_model` > 0 stub embeddings "embeds" (batch, seq,
    d_model) bfloat16: float32 normals * 0.02 from a generator seeded with
    seed * 7 + step, rounded to nearest even as `jnp.asarray(...,
    jnp.bfloat16)` rounds them.

    `sharding` = (a DeviceMesh on `device`'s type, {name: spec}) (the
    activation specs of `distributed.sharding`): the tensors it names are
    distributed over the mesh by their specs' `placements`, the others
    dropped, as the JAX function keeps only what its sharding names."""
    dev = resolve_tensor_device(device)
    toks = _tokens_for(cfg, step)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
    out = {"tokens": torch.from_numpy(toks).to(dev),
           "labels": torch.from_numpy(labels).to(dev)}
    if cfg.d_model:
        rng = np.random.default_rng(cfg.seed * 7 + step)
        emb = rng.standard_normal((cfg.batch, cfg.seq, cfg.d_model),
                                  np.float32) * 0.02
        out["embeds"] = torch.from_numpy(emb).to(torch.bfloat16).to(dev)
    if sharding is not None:
        mesh, specs = sharding
        out = {k: distribute_tensor(v, mesh, placements(specs[k], mesh))
               for k, v in out.items() if k in specs}
    return out
