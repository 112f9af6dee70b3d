"""Step-function builders shared by the trainer and the server.

make_train_step: loss -> grad -> (optionally compressed) gradient wire ->
AdamW (optionally compressed moments).  make_loss_and_grads: the step's
loss and gradients alone.  Activation checkpointing wraps every layer when
remat=True (the default training policy).

Counterpart of the JAX package's `train/step.py`, where the loss and
gradients stay inside `make_train_step`; here they are a builder of their
own so that a caller can read the gradients a step computes.  The JAX
`act_specs` (activation shardings) wait for the distribution slice
(ROADMAP.md Queue A item 13).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..kernels.quantize_blockwise import (dequantize_blockwise,
                                          quantize_blockwise)
from ..models import model as MD
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update

Batch = Dict[str, torch.Tensor]


class _LossAndGrads(nn.Module):
    """`MD.loss_fn` of `model` and its gradients, as one module call, so
    that `torch.func.functional_call` can run both over substituted (cast)
    parameters: a checkpointed layer recomputes its forward inside the
    backward pass, and it must find the same substituted tensors there."""

    def __init__(self, model: nn.Module, cfg: ModelConfig, remat: bool,
                 attn_impl: str):
        super().__init__()
        self.model, self.cfg = model, cfg
        self.remat, self.attn_impl = remat, attn_impl

    def forward(self, tokens, labels, wrt):
        loss = MD.loss_fn(self.model, self.cfg, tokens, labels,
                          remat=self.remat, attn_impl=self.attn_impl)
        return loss, torch.autograd.grad(loss, wrt)


def _qdq(g: torch.Tensor) -> torch.Tensor:
    """The q8 gradient wire: quantize, then dequantize into g's type."""
    if g.ndim == 0 or g.shape[-1] < 8:
        return g
    q, s = quantize_blockwise(g)
    return dequantize_blockwise(q, s, dtype=g.dtype)


def make_loss_and_grads(cfg: ModelConfig, remat: bool = True,
                        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                        attn_impl: str = "chunked") -> Callable:
    """Returns loss_and_grads(params, batch) -> (loss, {name: gradient}),
    the forward and backward pass of `make_train_step`'s step.

    Mixed precision: params are the f32 master copy; a `compute_dtype` cast
    of every float32 parameter with ndim > 1 feeds the forward and backward
    (norm scales stay float32), and the gradients flow through the cast
    back to float32 (one per parameter, keyed by `named_parameters()`).
    """

    def loss_and_grads(params, batch: Batch):
        names, masters = zip(*params.named_parameters())
        run = _LossAndGrads(params, cfg, remat, attn_impl)
        with torch.enable_grad():
            if compute_dtype is None:
                loss, grads = run(batch["tokens"], batch["labels"], masters)
            else:
                cast = {f"model.{n}": p.to(compute_dtype)
                        for n, p in zip(names, masters)
                        if p.dtype == torch.float32 and p.ndim > 1}
                loss, grads = torch.func.functional_call(
                    run, cast, (batch["tokens"], batch["labels"], masters))
        return loss.detach(), dict(zip(names, grads))

    return loss_and_grads


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, remat: bool = True,
                    grad_compression: Optional[str] = None,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                    attn_impl: str = "chunked") -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss).

    The loss and gradients come from `make_loss_and_grads` (the
    `compute_dtype` copy of the parameters feeds the forward and backward).
    Training uses CHUNKED (online-softmax, checkpointed) attention so S^2
    score tensors never materialize.

    grad_compression="q8" quantizes every gradient blockwise to int8 and
    back before AdamW sees it (the wire format of a gradient all-reduce:
    q8 values + f32 block scales), through the quantize and dequantize
    kernels on the card: the paper's update-path compression trade-off
    (alpha cost vs I/O saving).  `params` and `opt_state` are updated in
    place (see `adamw_update`).
    """
    if grad_compression not in (None, "q8"):
        raise ValueError(f"grad_compression {grad_compression!r} is not "
                         "None or 'q8'")
    loss_and_grads = make_loss_and_grads(cfg, remat, compute_dtype,
                                         attn_impl)

    def step(params, opt_state, batch: Batch):
        # the cast copy is gone once loss_and_grads returns, before AdamW
        loss, grads = loss_and_grads(params, batch)
        if grad_compression == "q8":
            for n, g in grads.items():   # in place: one extra at a time
                grads[n] = _qdq(g)
        params, opt_state = adamw_update(params, grads, opt_state, opt)
        return params, opt_state, loss

    return step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Returns prefill(params, batch) -> logits, with chunked (online-
    softmax) attention so long sequences never materialize S^2 scores."""

    def prefill(params, batch: Batch):
        return MD.forward(params, cfg, batch["tokens"], attn_impl="chunked")

    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    """Returns decode(params, state, tokens) -> (logits, new_state)."""

    def decode(params, state, tokens):
        return MD.decode_step(params, state, cfg, tokens)

    return decode
