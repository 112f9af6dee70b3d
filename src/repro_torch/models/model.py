"""Model assembly of the dense family: embedding -> layer stack -> head,
with the serving state and the one-token decode step.

Counterpart of the JAX package's `models/model.py` for its uniform dense
assembly (`family == "dense"`, `mixer == "attn"`, `frontend == "tokens"`).
`UniformLM` is a `torch.nn.Module` whose parameters mirror the JAX pytree
(`params["layers"][i]["attn"]["wq"]` is the JAX `params["layers"]["attn"]
["wq"][i]`), and the JAX functions keep their names: `init_params`,
`forward`, `loss_fn`, `init_serve_state`, `decode_step`, `reset_slot`.
The scanned layer stack becomes a Python loop over `layers`, and the JAX
function's per-layer `jax.checkpoint` (`remat=True`) a
`torch.utils.checkpoint` of each layer.  Every entry point runs
on the card unless the caller asks for the CPU; other families raise
`NotImplementedError` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig

State = Dict[str, object]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration this port cannot run
    yet."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP.md Queue A, "
            "item 10, remaining model families)")
    if cfg.hybrid is not None or cfg.mixer != "attn":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.mixer if cfg.hybrid is None else 'hybrid'}"
            " mixer is not ported yet (ROADMAP.md Queue A, item 10, remaining "
            "model families: Mamba, RWKV6, hybrid)")
    if cfg.frontend != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            "(ROADMAP.md Queue A, item 10, remaining model families: the "
            "stub frontends)")


class UniformLM(nn.Module):
    """The dense GQA transformer's parameters, indexable like the JAX
    pytree (`params["embed"]`, `params["layers"][i]["mlp"]["wi"]`).
    Built by `init_params`; calling it runs `forward`."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig,
                 device="cuda"):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = L._init(generator, (cfg.vocab_p, cfg.d_model),
                             device=dev)
        self.final_norm = L.init_rmsnorm(cfg.d_model, dev)
        self.lm_head = None if cfg.tie_embeddings else L._init(
            generator, (cfg.d_model, cfg.vocab_p), device=dev)
        self.layers = nn.ModuleList(nn.ModuleDict({
            "norm1": L.init_rmsnorm(cfg.d_model, dev),
            "norm2": L.init_rmsnorm(cfg.d_model, dev),
            "attn": L.init_attention(generator, cfg, dev),
            "mlp": L.init_mlp(generator, cfg, dev),
        }) for _ in range(cfg.n_layers))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, self.cfg, tokens)


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device="cuda") -> UniformLM:
    """Random float32 parameters (normal, scale 0.02; attention `wo`
    scaled by 1/sqrt(2 n_layers)) drawn from `generator`, or from a
    generator seeded with 0 on `device` when it is None."""
    if generator is None:
        generator = torch.Generator(resolve_device(device))
        generator.manual_seed(0)
    return UniformLM(generator, cfg, device)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _embed_input(params, cfg, tokens):
    return params["embed"][tokens.long()]


def _head(params, cfg, x):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return x @ params["lm_head"]


def _mlp_branch(lp, h, cfg):
    return lp["mlp"](h)


ATTN_IMPLS = {"full": L.attention_full, "chunked": L.attention_chunked}


def _layer(lp, x, cfg, attention):
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    x = x + attention(lp["attn"], h, cfg)
    h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
    return x + _mlp_branch(lp, h, cfg)


def forward(params: UniformLM, cfg: ModelConfig, tokens: torch.Tensor,
            attn_impl: str = "full", remat: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab_p).

    `attn_impl` is "full" or "chunked" (online softmax, for long training
    sequences); `remat=True` checkpoints each layer (the training memory
    policy): its activations are recomputed in the backward pass."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} is not one of "
                         f"{sorted(ATTN_IMPLS)}")
    attention = ATTN_IMPLS[attn_impl]
    x = _embed_input(params, cfg, tokens)
    for lp in params["layers"]:
        if remat:
            x = checkpoint(_layer, lp, x, cfg, attention, use_reentrant=False)
        else:
            x = _layer(lp, x, cfg, attention)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, cfg, x)


def loss_fn(params: UniformLM, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, remat: bool = False,
            attn_impl: str = "full") -> torch.Tensor:
    """Causal LM loss; padded vocab entries are masked out of the softmax."""
    logits = forward(params, cfg, tokens, attn_impl=attn_impl,
                     remat=remat).to(torch.float32)
    if cfg.vocab_p != cfg.vocab:
        mask = torch.arange(cfg.vocab_p, device=logits.device) < cfg.vocab
        logits = torch.where(mask, logits, L.NEG_INF)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# Serving state + decode step
# ---------------------------------------------------------------------------

def init_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     kv_dtype=torch.bfloat16, device="cuda") -> State:
    # pos is PER-SLOT (B,): slot-based continuous batching (vLLM-style)
    check_supported(cfg)
    dev = resolve_device(device)
    return {"pos": torch.zeros(batch, dtype=torch.int32, device=dev),
            "kv": L.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                  kv_dtype, dev)}


@torch.no_grad()
def decode_step(params: UniformLM, state: State, cfg: ModelConfig,
                tokens: torch.Tensor,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, State]:
    """One-token decode.  tokens: (B, 1) -> logits (B, 1, vocab_p).

    `active` (B,) bool marks slots that are really decoding this step.
    Inactive slots do not advance their position; their KV write lands at
    their current pos and is overwritten when the slot next steps for real.
    Their logits are garbage and must be ignored by the caller.  The KV
    cache is updated in place; the returned state holds the same cache
    tensors and a new `pos`."""
    x = _embed_input(params, cfg, tokens)
    pos = state["pos"]
    adv = torch.ones_like(pos) if active is None else active.to(pos.dtype)
    k_all, v_all = state["kv"]["k"], state["kv"]["v"]
    for i, lp in enumerate(params["layers"]):
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        att, _, _ = L.attention_decode(lp["attn"], h, cfg, k_all[i],
                                       v_all[i], pos)
        x = x + att
        h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
        x = x + _mlp_branch(lp, h, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, cfg, x), {"pos": pos + adv,
                                   "kv": {"k": k_all, "v": v_all}}


def reset_slot(state: State, cfg: ModelConfig, slot: int) -> State:
    """Zero one batch slot's serving state (slot reuse in the engine).  The
    dense family resets only `pos`: the per-slot pos mask hides stale KV
    entries."""
    out = dict(state)
    out["pos"] = state["pos"].clone()
    out["pos"][slot] = 0
    return out
