"""Step-function builders shared by the trainer and the server.

make_train_step: loss -> grad -> (optionally compressed) gradient wire ->
AdamW (optionally compressed moments).  make_loss_and_grads: the step's
loss and gradients alone.  Activation checkpointing wraps every layer when
remat=True (the default training policy).

Counterpart of the JAX package's `train/step.py`, where the loss and
gradients stay inside `make_train_step`; here they are a builder of their
own so that a caller can read the gradients a step computes.

Parameters on a mesh (`Trainer.reshard`: FSDP2 over the data axes, the
bf16 compute copy made by its mixed-precision policy) take the sharded
path: the model is called as a module, so that FSDP2 gathers the
parameters, the gradients come from `backward()` (reduce-scattered in
float32), and the wire, AdamW and their kernels work on each gradient's
local shard.  `act_specs` (the JAX step's activation shardings of
"hidden" and "logits") are held against what that path computes: every
activation batch-sharded over the data axes and whole over the model
axis, whose size is 1 (tensor parallelism is not ported); a spec asking
for another layout raises.

The q8 gradient wire maps quantize-then-dequantize over every gradient, as
the JAX step maps it over the gradient tree inside one jitted step; here
it works in buckets of at most `WIRE_BUCKET_BYTES` q8 bytes: one grouped
quantize launch writes a bucket's q8 values and scales (the wire format),
then one grouped dequantize launch writes the whole bucket back into the
gradients' own storage (in place: the q8 copy of one bucket is the only
extra memory).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..kernels.quantize_blockwise import (DEFAULT_BLOCK,
                                          dequantize_blockwise_group,
                                          quantize_blockwise_group)
from ..models import model as MD
from ..models.config import ModelConfig
from ..distributed.sharding import DistConfig, entry_axes, mesh_sizes
from ..launch.mesh import MeshShape
from ..models.interop import jax_ndim
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import local

Batch = Dict[str, torch.Tensor]

# q8 bytes (one per element) of the gradients one grouped quantize and one
# grouped dequantize of the q8 wire take at most: the bound on the wire's
# extra memory
WIRE_BUCKET_BYTES = 256 << 20


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

    def forward(self, tokens, labels, embeds, wrt):
        loss = MD.loss_fn(self.model, self.cfg, tokens, labels, embeds,
                          remat=self.remat, attn_impl=self.attn_impl)
        # a stub frontend's embedding table is unused: zero gradient, as
        # jax.grad gives it
        return loss, torch.autograd.grad(loss, wrt, materialize_grads=True)


def on_wire(g: torch.Tensor) -> bool:
    """Whether the q8 wire carries `g` (the reference leaves scalars and
    last dimensions under 8 as they are)."""
    return g.ndim > 0 and g.shape[-1] >= 8


def wire_buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """The indices of the tensors the q8 wire carries, in order, cut into
    buckets of at most `WIRE_BUCKET_BYTES` q8 bytes (a larger tensor is a
    bucket of its own): one grouped quantize and one grouped dequantize
    launch each."""
    buckets: List[List[int]] = []
    size = 0
    for i, t in enumerate(tensors):
        if not on_wire(t):
            continue
        if not buckets or size + t.numel() > WIRE_BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += t.numel()
    return buckets


def q8_wire(grads: Dict[str, torch.Tensor]) -> None:
    """The q8 gradient wire, in place: every gradient the wire carries is
    quantized blockwise to int8, then dequantized back into its own
    storage (a contiguous copy first, where it is not contiguous), one
    grouped launch each way per bucket."""
    for name, g in grads.items():
        if on_wire(g) and not g.is_contiguous():
            grads[name] = g.contiguous()
    gs = list(grads.values())
    for bucket in wire_buckets(gs):
        items = []
        for i in bucket:
            g = gs[i]
            nb = -(-g.shape[-1] // DEFAULT_BLOCK)
            items.append((g, torch.empty(g.shape, dtype=torch.int8,
                                         device=g.device),
                          torch.empty((*g.shape[:-1], nb),
                                      dtype=torch.float32, device=g.device)))
        quantize_blockwise_group(items)
        dequantize_blockwise_group([(q, s, g) for g, q, s in items])


def make_loss_and_grads(cfg: ModelConfig, remat: bool = True,
                        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                        attn_impl: str = "chunked") -> Callable:
    """Returns loss_and_grads(params, batch) -> (loss, {name: gradient}),
    the forward and backward pass of `make_train_step`'s step.

    Mixed precision: params are the f32 master copy; a `compute_dtype` cast
    of every float32 parameter whose JAX leaf has ndim > 1 feeds the
    forward and backward, as the JAX step casts its stacked tree (so the
    layers' 1-D parameters, norm scales included, are cast too, and only
    the final norm's scale stays float32), and the gradients flow through
    the cast back to float32 (one per parameter, keyed by
    `named_parameters()`).
    """

    def loss_and_grads(params, batch: Batch):
        names, masters = zip(*params.named_parameters())
        run = _LossAndGrads(params, cfg, remat, attn_impl)
        args = (batch["tokens"], batch["labels"], batch.get("embeds"),
                masters)
        with torch.enable_grad():
            if compute_dtype is None:
                loss, grads = run(*args)
            else:
                cast = {f"model.{n}": p.to(compute_dtype)
                        for n, p in zip(names, masters)
                        if p.dtype == torch.float32 and jax_ndim(n, p) > 1}
                loss, grads = torch.func.functional_call(run, cast, args)
        return loss.detach(), dict(zip(names, grads))

    return loss_and_grads


def on_mesh(params: nn.Module) -> bool:
    """Whether `params` live on a mesh (`Trainer.reshard`)."""
    return any(isinstance(p, DTensor) for p in params.parameters())


def check_act_specs(act_specs: Optional[Mapping], mesh,
                    data_axes: Sequence[str]) -> None:
    """Raise unless each of `act_specs`' "hidden" and "logits" specs asks
    for what the sharded path computes on `mesh`: the batch dimension over
    (a subset of) the data axes and every other dimension whole (or over
    axes of size 1)."""
    size = mesh_sizes(mesh)
    for key in ("hidden", "logits"):
        spec = (act_specs or {}).get(key)
        if spec is None:
            continue
        bad = [a for a in entry_axes(spec[0]) if a not in data_axes]
        bad += [a for e in spec[1:] for a in entry_axes(e)
                if size.get(a, 0) != 1]
        if bad:
            raise ValueError(
                f"act_specs[{key!r}] = {spec}: the sharded step computes "
                f"{key} batch-sharded over {tuple(data_axes)} and whole "
                f"elsewhere; axes {bad} would need tensor parallelism, "
                "which is not ported (ROADMAP.md Queue A)")


def make_sharded_loss_and_grads(cfg: ModelConfig, remat: bool = True,
                                attn_impl: str = "chunked",
                                act_specs: Optional[Mapping] = None
                                ) -> Callable:
    """`make_loss_and_grads` for parameters on a mesh (`params.mesh`, its
    data axes `params.data_axes`: `Trainer.reshard` sets both): returns
    loss_and_grads(params, batch) -> (loss, {name: the local shard of its
    gradient}).  The batch's DTensors give their local shards."""

    def loss_and_grads(params, batch: Batch):
        check_act_specs(act_specs, params.mesh, params.data_axes)
        tokens, labels = local(batch["tokens"]), local(batch["labels"])
        embeds = batch.get("embeds")
        with torch.enable_grad():
            logits = params(tokens, None if embeds is None else
                            local(embeds), attn_impl=attn_impl, remat=remat)
            loss = MD.loss_from_logits(logits, cfg, labels)
            loss.backward()
        grads = {}
        world = dist.get_world_size()
        for name, p in params.named_parameters():
            g = p.grad
            if g is None:
                # a stub frontend's embedding table is unused: zero
                g = torch.zeros_like(local(p))
            elif not isinstance(p, DTensor) and world > 1:
                # a parameter FSDP2 does not hold: average its gradient
                dist.all_reduce(g)
                g /= world
            grads[name] = local(g)
            p.grad = None
        return loss.detach(), grads

    return loss_and_grads


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, remat: bool = True,
                    grad_compression: Optional[str] = None,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                    attn_impl: str = "chunked",
                    act_specs: Optional[Mapping] = None) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss).

    The loss and gradients come from `make_loss_and_grads` (the
    `compute_dtype` copy of the parameters feeds the forward and backward),
    or, for parameters on a mesh, from `make_sharded_loss_and_grads` (the
    mesh's mixed-precision policy makes the copy; `act_specs` is checked
    there).  Training uses CHUNKED (online-softmax, checkpointed) attention
    so S^2 score tensors never materialize.

    grad_compression="q8" quantizes every gradient blockwise to int8 and
    back before AdamW sees it (the wire format of a gradient all-reduce:
    q8 values + f32 block scales), through the grouped quantize and
    dequantize kernels on the card (`q8_wire`, in place, in buckets): the
    paper's update-path compression trade-off (alpha cost vs I/O saving).
    `params` and `opt_state` are updated in place (see `adamw_update`).
    """
    if grad_compression not in (None, "q8"):
        raise ValueError(f"grad_compression {grad_compression!r} is not "
                         "None or 'q8'")
    loss_and_grads = make_loss_and_grads(cfg, remat, compute_dtype,
                                         attn_impl)
    sharded = make_sharded_loss_and_grads(cfg, remat, attn_impl, act_specs)

    def step(params, opt_state, batch: Batch):
        # the cast copy is gone once loss_and_grads returns, before AdamW
        run = sharded if on_mesh(params) else loss_and_grads
        loss, grads = run(params, batch)
        if grad_compression == "q8":
            q8_wire(grads)
        params, opt_state = adamw_update(params, grads, opt_state, opt)
        return params, opt_state, loss

    return step


def make_prefill_step(cfg: ModelConfig, act_specs: Optional[Mapping] = None,
                      mesh=None) -> Callable:
    """Returns prefill(params, batch) -> logits, with chunked (online-
    softmax) attention so long sequences never materialize S^2 scores.

    `act_specs` (the JAX step's activation shardings of "hidden" and
    "logits") are held, as `check_act_specs` holds the sharded train
    step's, against `mesh` (a DeviceMesh or `launch.mesh.MeshShape`; the
    JAX step's ambient mesh; by default one device, every axis of size
    1): the batch dimension over the axes other than a model axis larger
    than 1, every other dimension over axes of size 1.  A spec asking for
    a model axis larger than 1 raises (tensor parallelism is not ported);
    otherwise the logits are those of the call without specs."""
    if act_specs is not None:
        sizes = dict(mesh_sizes(mesh)) if mesh is not None else {}
        for spec in act_specs.values():
            for entry in spec:
                for a in entry_axes(entry):
                    sizes.setdefault(a, 1)
        data_axes = tuple(a for a, n in sizes.items()
                          if a != DistConfig.model_axis or n == 1)
        check_act_specs(act_specs, MeshShape(tuple(sizes),
                                             tuple(sizes.values())),
                        data_axes)

    def prefill(params, batch: Batch):
        return MD.forward(params, cfg, batch.get("tokens"),
                          batch.get("embeds"), attn_impl="chunked")

    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    """Returns decode(params, state, tokens) -> (logits, new_state)."""

    def decode(params, state, tokens):
        return MD.decode_step(params, state, cfg, tokens)

    return decode
