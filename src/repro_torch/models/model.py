"""Model assembly: embedding -> layer stack -> head, with the serving state
and the one-token decode step.

Counterpart of the JAX package's `models/model.py`.  Two assemblies cover
all 10 assigned architectures:

* `UniformLM`: homogeneous layers: dense GQA transformers, MoE
  transformers (MoE MLP in every layer, as the JAX assembly builds them),
  and RWKV6;
* `HybridLM`: Jamba-style groups, each 7 Mamba blocks + 1 attention block
  (the last position), MoE on even in-group positions.

Both are `torch.nn.Module`s whose parameters mirror the JAX pytree
(`params["layers"][i]["attn"]["wq"]` is the JAX `params["layers"]["attn"]
["wq"][i]`, `params["groups"][g]["mamba"][j]["in_proj"]` the JAX
`params["groups"]["mamba"]["in_proj"][g, j]`), and the JAX functions keep
their names: `init_params`, `forward`, `loss_fn`, `init_serve_state`,
`decode_step`, `reset_slot`.  The stub frontends (vlm, audio) take
`embeds=` in `forward` and `loss_fn`; `decode_step` embeds tokens.  The
scanned layer stack becomes a Python loop, and the JAX function's
per-layer (per-group) `jax.checkpoint` (`remat=True`) a
`torch.utils.checkpoint`.  Every entry point runs on the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_tensor_device
from . import layers as L
from . import mamba as M
from . import rwkv as R
from .config import ModelConfig

State = Dict[str, object]


def is_hybrid(cfg: ModelConfig) -> bool:
    return cfg.hybrid is not None


def is_rwkv(cfg: ModelConfig) -> bool:
    return cfg.mixer == "rwkv6"


class _LM(nn.Module):
    """Embedding, final norm and head, indexable like the JAX pytree
    (`params["embed"]`); calling the model runs `forward`."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig, dev):
        super().__init__()
        self.cfg = cfg
        self.embed = L._init(generator, (cfg.vocab_p, cfg.d_model),
                             device=dev)
        self.final_norm = L.init_rmsnorm(cfg.d_model, dev)
        self.lm_head = None if cfg.tie_embeddings else L._init(
            generator, (cfg.d_model, cfg.vocab_p), device=dev)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def forward(self, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                attn_impl: str = "full", remat: bool = False
                ) -> torch.Tensor:
        return forward(self, self.cfg, tokens, embeds, attn_impl, remat)


class UniformLM(_LM):
    """The uniform stack: `layers[i]` holds norm1, norm2 and either rwkv
    (RWKV6) or attn with mlp or moe."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig,
                 device="cuda"):
        dev = resolve_tensor_device(device)
        super().__init__(generator, cfg, dev)
        self.layers = nn.ModuleList(
            _init_uniform_layer(generator, cfg, dev)
            for _ in range(cfg.n_layers))


class HybridLM(_LM):
    """The Jamba stack: `groups[g]` holds mamba[j] / mamba_norm[j] (7),
    attn / attn_norm, moe[j] / moe_norm[j] (the even positions) and
    mlp[j] / mlp_norm[j] (the odd ones)."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig,
                 device="cuda"):
        dev = resolve_tensor_device(device)
        super().__init__(generator, cfg, dev)
        self.groups = nn.ModuleList(
            _init_group(generator, cfg, dev)
            for _ in range(cfg.n_layers // cfg.hybrid.group_size))


LM = Union[UniformLM, HybridLM]


def _init_uniform_layer(generator, cfg: ModelConfig, dev) -> nn.ModuleDict:
    p = nn.ModuleDict({"norm1": L.init_rmsnorm(cfg.d_model, dev),
                       "norm2": L.init_rmsnorm(cfg.d_model, dev)})
    if is_rwkv(cfg):
        p["rwkv"] = R.init_rwkv_block(generator, cfg, dev)
        return p
    p["attn"] = L.init_attention(generator, cfg, dev)
    if cfg.moe is not None:
        p["moe"] = L.init_moe(generator, cfg, dev)
    else:
        p["mlp"] = L.init_mlp(generator, cfg, dev)
    return p


def _init_group(generator, cfg: ModelConfig, dev) -> nn.ModuleDict:
    g = cfg.hybrid
    n_mamba = g.group_size - 1
    n_moe = g.group_size // 2
    n_mlp = g.group_size - n_moe

    def norms(n):
        return nn.ModuleList(L.init_rmsnorm(cfg.d_model, dev)
                             for _ in range(n))

    return nn.ModuleDict({
        "mamba": nn.ModuleList(M.init_mamba_block(generator, cfg, dev)
                               for _ in range(n_mamba)),
        "mamba_norm": norms(n_mamba),
        "attn": L.init_attention(generator, cfg, dev),
        "attn_norm": L.init_rmsnorm(cfg.d_model, dev),
        "moe": nn.ModuleList(L.init_moe(generator, cfg, dev)
                             for _ in range(n_moe)),
        "moe_norm": norms(n_moe),
        "mlp": nn.ModuleList(L.init_mlp(generator, cfg, dev)
                             for _ in range(n_mlp)),
        "mlp_norm": norms(n_mlp),
    })


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device="cuda") -> LM:
    """Random float32 parameters (normal, scale 0.02 unless the JAX init
    says otherwise) drawn from `generator`, or from a generator seeded with
    0 on `device` when it is None: a `HybridLM` for the hybrid family, a
    `UniformLM` for the others."""
    if generator is None:
        generator = torch.Generator(resolve_tensor_device(device))
        generator.manual_seed(0)
    return (HybridLM if is_hybrid(cfg) else UniformLM)(generator, cfg,
                                                       device)


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _embed_input(params, cfg, tokens, embeds):
    if embeds is not None:
        return embeds
    return params["embed"][tokens.long()]


def _head(params, cfg, x):
    if cfg.tie_embeddings:
        return L.einsum("bsd,vd->bsv", x, params["embed"])
    return L.mm(x, params["lm_head"])


def _mlp_branch(lp, h, cfg):
    return lp["moe"](h) if cfg.moe is not None else lp["mlp"](h)


ATTN_IMPLS = {"full": L.attention_full, "chunked": L.attention_chunked}


def _layer(lp, x, cfg, attention):
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    x = x + attention(lp["attn"], h, cfg)
    h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
    return x + _mlp_branch(lp, h, cfg)


def _rwkv_layer(lp, x, cfg):
    """One RWKV layer over a sequence from zero state (`forward`)."""
    b, d = x.shape[0], cfg.d_model
    st = R.init_rwkv_state(cfg, b, 1, x.dtype, x.device)
    st = {k: v[0] for k, v in st.items()}
    x, _ = R.rwkv_block(lp["rwkv"], x, cfg, st, lp["norm1"], lp["norm2"],
                        partial(L.rmsnorm, eps=cfg.norm_eps))
    return x


def _group_layers(gp, x, cfg, attend, mamba):
    """One hybrid group's layers in order: `attend(h)` at the attention
    position (the last), `mamba(j, h)` at Mamba position j; an MoE MLP
    after even positions, a dense MLP after odd ones."""
    g, eps = cfg.hybrid, cfg.norm_eps
    for pos in range(g.group_size):
        if pos == g.group_size - 1:
            x = x + attend(L.rmsnorm(gp["attn_norm"], x, eps))
        else:
            x = x + mamba(pos, L.rmsnorm(gp["mamba_norm"][pos], x, eps))
        mix = "moe" if pos % 2 == 0 else "mlp"
        j = pos // 2
        x = x + gp[mix][j](L.rmsnorm(gp[f"{mix}_norm"][j], x, eps))
    return x


def _group_forward(gp, x, cfg, attention):
    """One hybrid group over a full sequence, each Mamba block from zero
    state (`forward`)."""
    g = cfg.hybrid
    b, din = x.shape[0], M.d_inner(cfg)
    conv0 = torch.zeros((b, g.d_conv - 1, din), dtype=x.dtype,
                        device=x.device)
    ssm0 = torch.zeros((b, din, g.d_state), dtype=torch.float32,
                       device=x.device)
    return _group_layers(
        gp, x, cfg, lambda h: attention(gp["attn"], h, cfg),
        lambda j, h: M.mamba_sequence(gp["mamba"][j], h, cfg, conv0,
                                      ssm0)[0])


def forward(params: LM, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            attn_impl: str = "full", remat: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab_p), from `tokens`
    (B, S) or, for the stub frontends, `embeds` (B, S, D).

    `attn_impl` is "full" or "chunked" (online softmax, for long training
    sequences); `remat=True` checkpoints each layer (each hybrid group):
    its activations are recomputed in the backward pass."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} is not one of "
                         f"{sorted(ATTN_IMPLS)}")
    attention = ATTN_IMPLS[attn_impl]
    x = _embed_input(params, cfg, tokens, embeds)
    if is_hybrid(cfg):
        stack, fn = params["groups"], partial(_group_forward, cfg=cfg,
                                              attention=attention)
    elif is_rwkv(cfg):
        stack, fn = params["layers"], partial(_rwkv_layer, cfg=cfg)
    else:
        stack, fn = params["layers"], partial(_layer, cfg=cfg,
                                              attention=attention)
    for lp in stack:
        x = checkpoint(fn, lp, x, use_reentrant=False) if remat \
            else fn(lp, x)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, cfg, x)


def loss_fn(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, embeds: Optional[torch.Tensor] = None,
            remat: bool = False, attn_impl: str = "full") -> torch.Tensor:
    """Causal LM loss; padded vocab entries are masked out of the softmax."""
    return loss_from_logits(
        forward(params, cfg, tokens, embeds, attn_impl=attn_impl,
                remat=remat), cfg, labels)


def loss_from_logits(logits: torch.Tensor, cfg: ModelConfig,
                     labels: torch.Tensor) -> torch.Tensor:
    """`loss_fn` of the logits `forward` gave (cast to float32 here)."""
    logits = logits.to(torch.float32)
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
    """pos (B,) per slot; a KV cache for the attention layers; RWKV state
    (layers first, batch on axis 1, no KV cache) or the hybrid's Mamba
    conv and ssm state ((n_groups, n_mamba, B, ...), both float32)."""
    dev = resolve_tensor_device(device)
    # pos is PER-SLOT (B,): slot-based continuous batching (vLLM-style)
    state: State = {"pos": torch.zeros(batch, dtype=torch.int32, device=dev)}
    if is_hybrid(cfg):
        n_groups = cfg.n_layers // cfg.hybrid.group_size
        n_mamba = cfg.hybrid.group_size - 1
        state["kv"] = L.init_kv_cache(cfg, batch, max_len, n_groups,
                                      kv_dtype, dev)
        state["mamba"] = {
            k: v.view(n_groups, n_mamba, *v.shape[1:]) for k, v in
            M.init_mamba_state(cfg, batch, n_groups * n_mamba,
                               device=dev).items()}
    elif is_rwkv(cfg):
        state["rwkv"] = R.init_rwkv_state(cfg, batch, cfg.n_layers,
                                          device=dev)
    else:
        state["kv"] = L.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                      kv_dtype, dev)
    return state


@torch.no_grad()
def decode_step(params: LM, state: State, cfg: ModelConfig,
                tokens: torch.Tensor,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, State]:
    """One-token decode.  tokens: (B, 1) -> logits (B, 1, vocab_p).

    `active` (B,) bool marks slots that are really decoding this step.
    Inactive slots neither advance their position nor change their
    recurrent state: their KV write lands at their current pos and is
    overwritten when the slot next steps for real, and their new RWKV /
    Mamba state is replaced by the old (`torch.where` on the batch axis)
    in new tensors.  Their logits are garbage and must be ignored by the
    caller.  Every slot runs through the MoE layers, inactive ones
    included, and the experts' capacity counts them all, so with MoE a
    slot's logits depend on its neighbours' tokens, as in the JAX
    function.  The KV cache is updated in place; the returned state holds
    the same cache tensors."""
    x = _embed_input(params, cfg, tokens, None)
    pos = state["pos"]
    adv = torch.ones_like(pos) if active is None else active.to(pos.dtype)
    new_state: State = {"pos": pos + adv}

    def keep_active(new, old, batch_axis):
        """new where the slot is active, old otherwise."""
        if active is None:
            return new
        shape = [1] * new.ndim
        shape[batch_axis] = -1
        return torch.where(active.reshape(shape), new, old)

    if is_hybrid(cfg):
        kv, ms = state["kv"], state["mamba"]
        conv, ssm = [], []
        for gi, gp in enumerate(params["groups"]):
            new_conv, new_ssm = [], []

            def mamba(j, h, gi=gi, gp=gp, new_conv=new_conv,
                      new_ssm=new_ssm):
                out, c1, s1 = M.mamba_sequence(
                    gp["mamba"][j], h, cfg, ms["conv"][gi, j].to(h.dtype),
                    ms["ssm"][gi, j])
                new_conv.append(c1.to(torch.float32))
                new_ssm.append(s1)
                return out

            def attend(h, gi=gi, gp=gp):
                return L.attention_decode(gp["attn"], h, cfg, kv["k"][gi],
                                          kv["v"][gi], pos)[0]

            x = _group_layers(gp, x, cfg, attend, mamba)
            conv.append(torch.stack(new_conv))
            ssm.append(torch.stack(new_ssm))
        new_state["kv"] = kv
        # conv/ssm: (n_groups, n_mamba, B, ...) -- batch axis 2
        new_state["mamba"] = {
            "conv": keep_active(torch.stack(conv), ms["conv"], 2),
            "ssm": keep_active(torch.stack(ssm), ms["ssm"], 2)}
    elif is_rwkv(cfg):
        rs = state["rwkv"]
        new = {k: [] for k in rs}
        for i, lp in enumerate(params["layers"]):
            x, st = R.rwkv_block(lp["rwkv"], x, cfg,
                                 {k: v[i] for k, v in rs.items()},
                                 lp["norm1"], lp["norm2"],
                                 partial(L.rmsnorm, eps=cfg.norm_eps))
            for k, v in st.items():
                new[k].append(v)
        # tm/cm/wkv: (L, B, ...) -- batch axis 1
        new_state["rwkv"] = {k: keep_active(torch.stack(v), rs[k], 1)
                             for k, v in new.items()}
    else:
        k_all, v_all = state["kv"]["k"], state["kv"]["v"]
        for i, lp in enumerate(params["layers"]):
            h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
            att, _, _ = L.attention_decode(lp["attn"], h, cfg, k_all[i],
                                           v_all[i], pos)
            x = x + att
            h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
            x = x + _mlp_branch(lp, h, cfg)
        new_state["kv"] = {"k": k_all, "v": v_all}
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, cfg, x), new_state


def reset_slot(state: State, cfg: ModelConfig, slot: int) -> State:
    """Zero one batch slot's serving state (slot reuse in the engine): its
    pos and its RWKV / Mamba state, in new tensors.  Attention KV needs no
    reset: the per-slot pos mask hides stale entries."""
    out = dict(state)
    out["pos"] = state["pos"].clone()
    out["pos"][slot] = 0
    for name, axis in (("rwkv", 1), ("mamba", 2)):
        if name in state:
            out[name] = {}
            for k, v in state[name].items():
                v = v.clone()
                v.select(axis, slot).zero_()
                out[name][k] = v
    return out
