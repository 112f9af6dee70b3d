"""Input shape cells and their meta-device stand-ins for the dry run.

The four shape cells per LM architecture (the JAX package's
`launch/specs.py`):

    train_4k     seq 4096   global_batch 256   (training step)
    prefill_32k  seq 32768  global_batch 32    (inference prefill)
    decode_32k   KV 32768   global_batch 128   (one-token decode)
    long_500k    KV 524288  global_batch 1     (long-context decode;
                 SSM/hybrid only: full-attention archs are skipped)

Where the reference builds `jax.ShapeDtypeStruct`s with shardings, the
port builds tensors on the `meta` device (shapes and dtypes, no storage),
each beside its spec (`Sharded`): no device memory is touched.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..distributed.sharding import (DistConfig, Spec, activation_specs,
                                    axes_size, param_specs,
                                    serve_state_specs)
from ..models import model as MD
from ..models.config import ModelConfig

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


class Sharded(NamedTuple):
    """A meta tensor (the global shape and dtype) and its spec."""
    tensor: torch.Tensor
    spec: Spec


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (shape-sheet rule)."""
    if shape == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("skipped: pure full-attention arch; long_500k "
                       "requires sub-quadratic sequence mixing")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_divides(batch: int, mesh, dist: DistConfig) -> bool:
    """Whether the batch shards over the data-parallel axes."""
    return batch % axes_size(tuple(dist.dp_axes), mesh) == 0


def input_specs(cfg: ModelConfig, shape: str, mesh, dist: DistConfig,
                kv_dtype=torch.bfloat16) -> Dict[str, Any]:
    """The cell's step-function inputs as `Sharded` meta tensors (for a
    decode cell, "state" is the serving state's nested dict of them).  For
    stub frontends (vlm/audio), precomputed embeddings ride beside the
    tokens."""
    info = SHAPES[shape]
    b, s = info["batch"], info["seq"]
    act = activation_specs(dist)
    if info["kind"] in ("train", "prefill"):
        batch = {"tokens": Sharded(_meta((b, s), torch.int32),
                                   act["tokens"])}
        if info["kind"] == "train":
            batch["labels"] = Sharded(_meta((b, s), torch.int32),
                                      act["labels"])
        if cfg.frontend != "tokens":
            batch["embeds"] = Sharded(_meta((b, s, cfg.d_model),
                                            torch.bfloat16), act["embeds"])
        return batch
    # decode: one new token + serving state of length `seq`
    state = MD.init_serve_state(cfg, b, s, kv_dtype=kv_dtype, device="meta")
    specs = serve_state_specs(state, cfg, dist, mesh, b)

    def pair(node, sp):
        if isinstance(node, dict):
            return {k: pair(v, sp[k]) for k, v in node.items()}
        return Sharded(node, sp)

    tok_spec = act["tokens"] if batch_divides(b, mesh, dist) else \
        (None, None)
    return {"tokens": Sharded(_meta((b, 1), torch.int32), tok_spec),
            "state": pair(state, specs)}


def model_shardings(cfg: ModelConfig, mesh, dist: DistConfig,
                    param_dtype=torch.bfloat16):
    """(the model on the meta device in `param_dtype`, {parameter name:
    spec})."""
    model = MD.init_params(torch.Generator(), cfg, "meta").to(param_dtype)
    return model, param_specs(model, cfg, dist, mesh)
