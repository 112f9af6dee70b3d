"""AdamW with optionally COMPRESSED (blockwise-int8) first/second moments.

The optimizer state is the largest persistent tensor class in training --
the direct analogue of the paper's clustered index.  The physical-design
advisor (`repro_torch.design`) decides per tensor class whether moments
are stored f32 (fast, 8 bytes/param) or q8 (2 bytes/param + scales,
paying a quantize and a dequantize per moment per step -- the alpha/beta
of Appendix A; on the card one grouped launch each way per parameter).

The q8 codec is `kernels.quantize_blockwise`; v (second moment) is
quantized in sqrt space to preserve dynamic range.

Counterpart of the JAX package's `optim/adamw.py`, with the same
arithmetic in the same order (the bias corrections `1 - b ** t` in
float32 from an int32 step).  Differences:

* The JAX `use_pallas` option is gone.  There it picks between the Pallas
  kernels (`ops.*`) and their jnp oracles (`ref.*`), which give the same
  bits; here the device of the tensors picks the route: the hand-written
  quantize and dequantize kernels on CUDA tensors, their plain versions on
  CPU tensors, again with the same bits.
* Parameters are a module (the port's `UniformLM`); gradients and moments
  are keyed by its parameter names (`named_parameters()`, e.g.
  "layers.0.attn.wq"), one entry per layer where the JAX pytree stacks the
  layers (`models.interop.opt_state_from_numpy` converts).
* `adamw_update` updates in place and returns what it was given, as the
  JAX function returns new parameters and state: the new values go into
  the parameter tensors (under `torch.no_grad()`), and each parameter's
  new moments replace its old ones in the state as they are made, so the
  old and new moments of only one tensor are in memory at a time (not
  two copies of every moment).
* The JAX `q_block` option is gone: the moments use the kernels'
  `DEFAULT_BLOCK` (128), the block of the gradient wire and of the layout
  advisor's q8 costing.
* Parameters on a mesh (`torch.distributed.tensor.DTensor`s, after
  `Trainer.reshard`) keep moments with their placements; the update runs
  on the local shards (the gradients it is given are local shards too),
  through the same kernels, and a q8 moment's blocks are its local
  shard's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..kernels.quantize_blockwise import (DEFAULT_BLOCK,
                                          dequantize_blockwise_group,
                                          quantize_blockwise_group)

State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_codec: str = "f32"      # "f32" | "q8"


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view), or `t` itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def like(new: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The local tensor `new` with the placements of `ref` where `ref` is a
    DTensor (a moment of a parameter on a mesh), else `new` itself."""
    if isinstance(ref, DTensor):
        return DTensor.from_local(new, ref.device_mesh, ref.placements,
                                  run_check=False)
    return new


def adamw_init(params: nn.Module, cfg: AdamWConfig) -> State:
    """Zero moments for every parameter (with the placements of a
    parameter on a mesh), and step 0 (an int32 tensor on the parameters'
    device)."""
    if cfg.state_codec not in ("f32", "q8"):
        raise ValueError(f"state_codec {cfg.state_codec!r} is not f32 or q8")
    moments = {}
    for name, p in params.named_parameters():
        lp = local(p)
        if cfg.state_codec == "q8":
            s_shape = (*lp.shape[:-1], -(-lp.shape[-1] // DEFAULT_BLOCK))
            mom = {"m_q": torch.zeros(lp.shape, dtype=torch.int8,
                                      device=lp.device),
                   "m_s": torch.zeros(s_shape, dtype=torch.float32,
                                      device=lp.device),
                   "v_q": torch.zeros(lp.shape, dtype=torch.int8,
                                      device=lp.device),
                   "v_s": torch.zeros(s_shape, dtype=torch.float32,
                                      device=lp.device)}
        else:
            mom = {"m": torch.zeros(lp.shape, dtype=torch.float32,
                                    device=lp.device),
                   "v": torch.zeros(lp.shape, dtype=torch.float32,
                                    device=lp.device)}
        moments[name] = {k: like(t, p) for k, t in mom.items()}
    device = local(next(params.parameters())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "moments": moments}


@torch.no_grad()
def adamw_update(params: nn.Module, grads: Mapping[str, torch.Tensor],
                 state: State, cfg: AdamWConfig) -> Tuple[nn.Module, State]:
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def new_param(p, m, v):
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        return p - cfg.lr * (update + cfg.weight_decay * p.to(torch.float32)
                             ).to(p.dtype)

    def upd_f32(p, g, mom):
        g = g.to(torch.float32)
        m = cfg.b1 * mom["m"] + (1 - cfg.b1) * g
        v = cfg.b2 * mom["v"] + (1 - cfg.b2) * g * g
        p.copy_(new_param(p, m, v))
        return {"m": m, "v": v}

    def upd_q8(p, g, mom):
        # m and sqrt(v) of the parameter as one two-item group each way
        g = g.to(torch.float32)
        m = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        v_sqrt = torch.empty_like(m)
        dequantize_blockwise_group([(mom["m_q"], mom["m_s"], m),
                                    (mom["v_q"], mom["v_s"], v_sqrt)])
        v = v_sqrt * v_sqrt
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        p.copy_(new_param(p, m, v))
        new = {k: torch.empty_like(mom[k]) for k in ("m_q", "m_s", "v_q",
                                                     "v_s")}
        quantize_blockwise_group([(m, new["m_q"], new["m_s"]),
                                  (torch.sqrt(v), new["v_q"], new["v_s"])])
        return new

    upd = upd_q8 if cfg.state_codec == "q8" else upd_f32
    moments = state["moments"]
    for name, p in params.named_parameters():
        new = upd(local(p), local(grads[name]),
                  {k: local(t) for k, t in moments[name].items()})
        moments[name] = {k: like(t, p) for k, t in new.items()}
    state["step"] = step
    return params, state
