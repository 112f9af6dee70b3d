"""Batched serving engine: slot-based continuous batching over decode_step.

Requests carry a prompt; the engine prefills them into free slots of a
fixed-size batch, decodes all active slots each step, and retires slots on
EOS (when `EngineConfig.eos_id` is set), on `max_new_tokens`, or on context
overflow (the slot's position reaching `max_len`).  The KV cache is stored
in bfloat16 or float32 (`EngineConfig.kv_dtype`); the weights are served
as given (the layout advisor's "q8 weights" choice runs through
`models.layers.quantize_mlp` / `mlp_quantized`, not through this engine).

Slot isolation is the engine's core invariant: every decode -- including
the per-token prefill of a newly admitted request -- passes an `active`
mask to `decode_step`, so slots that are not really stepping neither
advance their KV position nor change their recurrent (RWKV / Mamba)
state.  A request of a model without MoE layers therefore produces
exactly the same tokens whether it runs alone or with requests admitted
mid-flight into neighboring slots.  MoE layers are the exception, as in
the JAX package: every slot, inactive ones included, is routed through
the experts, whose capacity is sized from all the slots' tokens, so a
slot's MoE output (and its logits) can depend on what its neighbours
hold.  Retired slots are reset before reuse so a new occupant
never attends over its predecessor's KV entries or inherits its
recurrent state.

Counterpart of the JAX package's `serve/engine.py`.  The jitted decode is
an eager call; the next tokens of all active slots come from one argmax
over the batch and one read to the host per step (first index on a tie,
as `jnp.argmax`).  The engine runs on the card unless `device="cpu"` is
asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import model as MD
from ..models.config import ModelConfig


class QueueFull(RuntimeError):
    """submit() on an engine whose bounded request queue is at capacity."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False  # retired on context overflow, not EOS/max_tokens
    # last prompt token, carried from prefill into the first decode step
    _pending: Optional[int] = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 4
    max_len: int = 256
    kv_dtype: str = "bf16"   # "bf16" | "f32"
    eos_id: Optional[int] = None    # retire a slot when it emits this token
    max_queue: Optional[int] = None  # submit() raises QueueFull beyond this


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: MD.LM,
                 ec: EngineConfig, device="cuda"):
        self.device = resolve_device(device)
        held = params["embed"].device
        if held != self.device:
            raise ValueError(f"params live on {held}, the engine on "
                             f"{self.device}")
        if ec.kv_dtype not in ("bf16", "f32"):
            raise ValueError(f"kv_dtype {ec.kv_dtype!r} (bf16 or f32)")
        self.cfg = cfg
        self.ec = ec
        self.params = params
        kv_dt = torch.float32 if ec.kv_dtype == "f32" else torch.bfloat16
        self.state = MD.init_serve_state(cfg, ec.batch_slots, ec.max_len,
                                         kv_dtype=kv_dt, device=self.device)
        self.slots: List[Optional[Request]] = [None] * ec.batch_slots
        # per-slot sequence position (== state["pos"] on the device): the
        # KV index the slot's NEXT token will be written to.  Drives the
        # context-overflow retirement check without a device readback.
        self.slot_pos = np.zeros(ec.batch_slots, np.int32)
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._decode = lambda p, s, t, a: MD.decode_step(p, s, cfg, t, a)
        self.steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.ec.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens cannot fit a "
                f"max_len={self.ec.max_len} KV cache")
        if self.ec.max_queue is not None and \
                len(self.queue) >= self.ec.max_queue:
            raise QueueFull(
                f"request queue at capacity ({self.ec.max_queue})")
        self.queue.append(req)

    def _admit(self) -> None:
        """Prefill queued requests into free slots, token by token.

        Prefill runs through the shared batch decode step with an
        `active` mask naming ONLY the admitted slot, so concurrently
        decoding slots neither advance their positions nor write
        pad-token KV -- admission is invisible to in-flight requests."""
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self.slots[i] = req
            if self.slot_pos[i]:
                # slot reuse: zero the retired occupant's position and
                # recurrent state so the new prompt starts at position 0
                # and never attends over its predecessor's KV entries
                self.state = MD.reset_slot(self.state, self.cfg, i)
                self.slot_pos[i] = 0
            for tok in req.prompt[:-1]:
                self._step_token(i, tok)
            self.slot_pos[i] = len(req.prompt) - 1
            req._pending = req.prompt[-1]

    def _to_device(self, toks: np.ndarray, mask: np.ndarray):
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _step_token(self, slot: int, token: int) -> None:
        """One single-slot decode step (prefill): only `slot` is active."""
        toks = np.zeros((self.ec.batch_slots, 1), np.int32)
        toks[slot, 0] = token
        mask = np.zeros(self.ec.batch_slots, bool)
        mask[slot] = True
        _, self.state = self._decode(self.params, self.state,
                                     *self._to_device(toks, mask))

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine iteration: admit, decode all active slots, retire.

        Retirement: EOS (`ec.eos_id`, when set), `max_new_tokens`, or
        context overflow -- the slot's position reaching `max_len`, where
        the next KV write would fall off the cache; overflow retirement
        marks the request `truncated`."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        toks = np.zeros((self.ec.batch_slots, 1), np.int32)
        mask = np.zeros(self.ec.batch_slots, bool)
        for i in active:
            req = self.slots[i]
            mask[i] = True
            toks[i, 0] = req._pending if req._pending is not None else \
                req.out_tokens[-1]
        logits, self.state = self._decode(self.params, self.state,
                                          *self._to_device(toks, mask))
        self.steps += 1
        # every slot's next token in one device call and one host read
        nxt_all = logits[:, 0, : self.cfg.vocab].argmax(dim=-1).tolist()
        for i in active:
            req = self.slots[i]
            req._pending = None
            self.slot_pos[i] += 1
            nxt = nxt_all[i]
            req.out_tokens.append(nxt)
            hit_eos = self.ec.eos_id is not None and nxt == self.ec.eos_id
            overflow = int(self.slot_pos[i]) >= self.ec.max_len
            if hit_eos or overflow or \
                    len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                req.truncated = (overflow and not hit_eos
                                 and len(req.out_tokens) < req.max_new_tokens)
                self.finished[req.uid] = req
                self.slots[i] = None

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.steps < max_steps:
            self.step()
