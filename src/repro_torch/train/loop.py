"""Fault-tolerant training loop.

* checkpoint/restart: atomic compressed checkpoints (repro_torch.checkpoint),
  auto-resume from the latest on construction;
* straggler mitigation: per-step wall-time EMA; a step slower than
  `straggler_factor` x EMA is logged and counted -- the hook where a
  multi-host deployment would trigger re-sharding away from the slow host
  (`on_straggler` exposes it for tests and integrations);
* elastic scaling: `reshard(mesh, specs)` moves the parameters and the
  AdamW moments onto a `DeviceMesh` (FSDP2 over its data axes; works
  because the data pipeline is stateless-in-step);
* gradient compression and compressed optimizer moments come from the
  design advisor's LayoutPlan (the paper's technique driving the trainer).

Counterpart of the JAX package's `train/loop.py`.  The plan is made for
one card at construction; `n_chips` follows the mesh after `reshard`.
Checkpoints take the port's default codecs (zlib; `checkpoint.manager`),
and a trainer resumes from a checkpoint of the JAX package's as well.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from ..checkpoint.manager import CheckpointConfig, CheckpointManager
from ..data.pipeline import DataConfig, batch_at
from ..design.advisor import plan_layout
from ..device import resolve_device
from ..distributed.sharding import (DistConfig, Spec, activation_specs,
                                    entry_axes, mesh_sizes)
from ..models import model as MD
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init
from .step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 64
    lr: float = 3e-4
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_last_k: int = 2
    straggler_factor: float = 3.0
    # one H100's device memory; the JAX package's default is 16e9 (a TPU
    # v5e chip's HBM)
    hbm_budget_bytes: float = 80e9
    use_design_advisor: bool = True
    seed: int = 0
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tc = tc
        self.on_straggler = on_straggler
        self.straggler_events: List[int] = []
        self.history: List[Dict[str, float]] = []

        # --- the paper's advisor chooses the physical layout ---
        self.mesh = None
        self._sharding = None       # the batch's placements after reshard
        self.n_chips = 1
        flops = 6.0 * cfg.param_count() * tc.batch * tc.seq / self.n_chips
        if tc.use_design_advisor:
            self.plan = plan_layout(cfg, "train", tc.batch, tc.seq,
                                    self.n_chips,
                                    tc.hbm_budget_bytes,
                                    base_flops_per_chip=flops)
            moments = ("q8" if self.plan.choices.get("adam_m") == "q8"
                       else "f32")
            grad_comp = ("q8" if self.plan.choices.get("grad_wire") == "q8"
                         else None)
        else:
            self.plan = None
            moments, grad_comp = "f32", None

        self.opt_cfg = AdamWConfig(lr=tc.lr, state_codec=moments)
        self.data_cfg = DataConfig(
            vocab=cfg.vocab, batch=tc.batch, seq=tc.seq, seed=tc.seed,
            d_model=cfg.d_model if cfg.frontend != "tokens" else 0)
        self.grad_compression = grad_comp
        self._step_fn = make_train_step(
            cfg, self.opt_cfg, remat=True, grad_compression=grad_comp,
            attn_impl="chunked" if tc.seq >= 2048 else "full")

        self.params = MD.init_params(
            torch.Generator(self.device).manual_seed(tc.seed), cfg,
            self.device)
        self.opt_state = adamw_init(self.params, self.opt_cfg)
        self.step = 0

        self.ckpt: Optional[CheckpointManager] = None
        if tc.checkpoint_dir:
            self.ckpt = CheckpointManager(CheckpointConfig(
                directory=tc.checkpoint_dir, keep_last_k=tc.keep_last_k))
            if self.ckpt.latest_step() is not None:
                self.restore()

    # ------------------------------------------------------------------
    def restore(self) -> None:
        """Load the latest checkpoint into the parameters and optimizer
        state, in place, and continue from its step."""
        if self.ckpt is None:
            raise ValueError("restore() needs TrainConfig.checkpoint_dir")
        step, _, _, _ = self.ckpt.restore_into(self.params, self.opt_state)
        self.step = step
        print(f"[trainer] resumed from step {step}")

    def reshard(self, mesh, specs: Mapping[str, Spec],
                act_specs: Optional[Mapping] = None) -> None:
        """Elastic scaling: move the parameters and the AdamW moments onto
        `mesh`, a DeviceMesh with a "model" axis and data axes ("data",
        and "pod" on the multi-pod mesh), as `specs` ({name: spec},
        `distributed.sharding.param_specs`) shard them (`shard_params`
        with the step's bfloat16 compute copy, `shard_opt_state`); the
        batches follow with the activation specs' placements.  `act_specs`
        go to the step (`make_train_step`).  Raises NotImplementedError for
        a model axis larger than 1."""
        shard_params(self.params, mesh, specs)
        shard_opt_state(self.opt_state, self.params)
        act = activation_specs(DistConfig(
            pod_axis="pod" if "pod" in mesh.mesh_dim_names else None))
        self._sharding = (mesh, {k: act[k] for k in ("tokens", "labels",
                                                     "embeds")})
        self.mesh = mesh
        self.n_chips = mesh.size()
        self._step_fn = make_train_step(
            self.cfg, self.opt_cfg, remat=True,
            grad_compression=self.grad_compression,
            attn_impl="chunked" if self.tc.seq >= 2048 else "full",
            act_specs=act_specs)

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        steps = steps if steps is not None else self.tc.steps
        ema = None
        target = self.step + steps
        first = True
        while self.step < target:
            batch = batch_at(self.data_cfg, self.step, self.device,
                             sharding=self._sharding)
            t0 = time.perf_counter()
            self.params, self.opt_state, loss = self._step_fn(
                self.params, self.opt_state, batch)
            loss = float(loss)          # waits for the step's device work
            dt = time.perf_counter() - t0
            if first:
                first = False  # first step (kernel builds): not in the EMA
            elif ema is None:
                ema = dt
            else:
                if dt > self.tc.straggler_factor * ema:
                    self.straggler_events.append(self.step)
                    if self.on_straggler:
                        self.on_straggler(self.step, dt / ema)
                ema = 0.9 * ema + 0.1 * dt
            self.history.append({"step": self.step, "loss": loss,
                                 "seconds": dt})
            if self.step % self.tc.log_every == 0:
                print(f"[trainer] step {self.step:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)")
            self.step += 1
            if (self.ckpt is not None and
                    self.step % self.tc.checkpoint_every == 0):
                self.ckpt.save(self.step, self.params, self.opt_state,
                               extra={"loss": loss})
        if self.ckpt is not None:
            self.ckpt.save(self.step, self.params, self.opt_state,
                           extra={"loss": self.history[-1]["loss"]})
            self.ckpt.wait()
        return {"final_loss": self.history[-1]["loss"],
                "first_loss": self.history[0]["loss"],
                "stragglers": list(self.straggler_events)}


def shard_params(params, mesh, specs: Mapping[str, Spec],
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16
                 ) -> None:
    """Shard the model `params` in place over `mesh`'s data axes ("data",
    and "pod" on the multi-pod mesh, which then replicates: HSDP) with
    FSDP2 (`fully_shard`), each parameter on the dimension its spec's data
    entry names (dimension 0 where the spec leaves it whole: FSDP2 shards
    every parameter it holds).  The mixed precision is the unsharded
    step's (`make_loss_and_grads`): a `compute_dtype` copy for the forward
    and backward (none for None), float32 gradients, and the final norm's
    scale, which that step does not cast, whole in float32 outside FSDP2.
    Sets `params.mesh` and `params.data_axes` for the step.  Raises
    NotImplementedError for a model axis larger than 1: tensor parallelism
    does not run on one card (ROADMAP.md Queue A); the specs and the dry
    run cover it."""
    sizes = mesh_sizes(mesh)
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"a model axis of {sizes['model']}: tensor parallelism is not "
            "ported (ROADMAP.md Queue A); the specs and the dry run cover "
            "it")
    data_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    by_id = {id(p): specs[n] for n, p in params.named_parameters()}

    def shard_dim(p):
        dims = [d for d, e in enumerate(by_id[id(p)])
                if "data" in entry_axes(e)]
        return Shard(dims[0] if dims else 0)

    cast = compute_dtype is not None
    fully_shard(params, mesh=mesh[data_axes], shard_placement_fn=shard_dim,
                mp_policy=MixedPrecisionPolicy(param_dtype=compute_dtype,
                                               reduce_dtype=torch.float32),
                ignored_params=set(params.final_norm.parameters())
                if cast else None)
    params.mesh, params.data_axes = mesh, data_axes


def shard_opt_state(opt_state, params) -> None:
    """Give each AdamW moment of a sharded parameter that parameter's
    placements, in place (the reference shards the optimizer state by the
    parameter specs)."""
    moments = opt_state["moments"]
    for name, p in params.named_parameters():
        if isinstance(p, DTensor):
            moments[name] = {
                k: distribute_tensor(t, p.device_mesh, p.placements)
                for k, t in moments[name].items()}
