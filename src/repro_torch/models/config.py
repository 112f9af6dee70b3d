"""Model configuration for the assigned architecture pool (plain Python,
the same dataclasses as the JAX package's `models/config.py`).

One ModelConfig describes any of the 10 assigned backbones: dense GQA
transformers, MoE transformers, RWKV6 (attention-free), and the Jamba-style
hybrid (Mamba + attention 1:7 with interleaved MoE).

The `*_padded` fields hold the head, expert and vocab counts padded to
divide a tensor-parallel model axis (`pad_for_tp`); 0 means the logical
count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    every_k_layers: int = 1      # MoE MLP on layers where layer % k == k-1
    n_experts_padded: int = 0    # 0 => n_experts

    @property
    def experts(self) -> int:
        return self.n_experts_padded or self.n_experts


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style: groups of `group_size` layers, the last one attention,
    the rest Mamba; MoE on even positions within the group."""
    group_size: int = 8          # 7 mamba + 1 attention
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64         # rank of the data-dependent decay LoRA
    gate_lora: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    mixer: str = "attn"          # attn | rwkv6 (hybrid handled separately)
    mlp: str = "swiglu"          # swiglu | relu2
    moe: Optional[MoEConfig] = None
    hybrid: Optional[HybridConfig] = None
    rwkv: Optional[RWKVConfig] = None
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = "tokens"     # tokens | patch_stub (vlm) | frame_stub (audio)
    # padded values; 0 => use logical
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0
    vocab_padded: int = 0

    @property
    def heads(self) -> int:
        return self.n_heads_padded or self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads_padded or self.n_kv_heads

    @property
    def vocab_p(self) -> int:
        return self.vocab_padded or self.vocab

    @property
    def attn_layers(self) -> int:
        if self.hybrid is not None:
            return self.n_layers // self.hybrid.group_size
        return self.n_layers if self.mixer == "attn" else 0

    def param_count(self, padded: bool = False) -> int:
        """Analytic parameter count (logical by default)."""
        d = self.d_model
        nh = self.heads if padded else self.n_heads
        nkv = self.kv_heads if padded else self.n_kv_heads
        voc = self.vocab_p if padded else self.vocab
        hd = self.d_head

        def attn_params():
            return d * nh * hd + 2 * d * nkv * hd + nh * hd * d

        def moe_params():
            e = self.moe.experts if padded else self.moe.n_experts
            return d * e + e * 3 * d * self.moe.d_ff_expert

        def mlp_params(layer_idx: int):
            if self.hybrid is not None:
                # hybrid: MoE on even in-group positions (1:1 interleave)
                if self.moe is not None and \
                        (layer_idx % self.hybrid.group_size) % 2 == 0:
                    return moe_params()
            elif self.moe is not None and \
                    layer_idx % self.moe.every_k_layers == self.moe.every_k_layers - 1:
                return moe_params()
            mult = 3 if self.mlp == "swiglu" else 2
            return mult * d * self.d_ff

        total = voc * d * (1 if self.tie_embeddings else 2)
        if self.hybrid is not None:
            g = self.hybrid
            d_in = g.expand * d
            mamba = (d * 2 * d_in + g.d_conv * d_in + d_in * g.d_state * 2
                     + d_in * 2 + d_in * g.d_state + d_in * d)
            for i in range(self.n_layers):
                is_attn = (i % g.group_size == g.group_size - 1)
                total += attn_params() if is_attn else mamba
                total += mlp_params(i)
                total += 2 * d  # norms
        elif self.mixer == "rwkv6":
            r = self.rwkv or RWKVConfig()
            # time-mix: r,k,v,g,o projections + decay LoRA + token-shift mixes
            tm = 5 * d * d + 2 * r.decay_lora * d + 6 * d
            cm = 2 * d * self.d_ff + d * d  # channel mix K, V, R
            total += self.n_layers * (tm + cm + 2 * d)
        else:
            for i in range(self.n_layers):
                total += attn_params() + mlp_params(i) + 2 * d
        return int(total)


def _ceil_to(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


def pad_for_tp(cfg: ModelConfig, tp: int, pad_kv: bool = True) -> ModelConfig:
    """Pad head/expert/vocab counts to divide the model axis (function-
    preserving: padded heads/experts carry zero output weights).

    pad_kv=False keeps the LOGICAL kv-head count (used when the KV cache is
    sequence-sharded instead of head-sharded: no padding waste; the kv
    projections replicate, which is cheap)."""
    changes = {}
    if cfg.mixer == "attn" or cfg.hybrid is not None:
        nh = _ceil_to(cfg.n_heads, tp)
        nkv = cfg.n_kv_heads
        if pad_kv:
            nkv = tp if nkv < tp else _ceil_to(nkv, tp)
        if nh != cfg.n_heads:
            changes["n_heads_padded"] = nh
        if nkv != cfg.n_kv_heads:
            changes["n_kv_heads_padded"] = nkv
    if cfg.vocab % tp:
        changes["vocab_padded"] = _ceil_to(cfg.vocab, tp)
    moe = cfg.moe
    if moe is not None and moe.experts % tp:
        moe = dataclasses.replace(moe,
                                  n_experts_padded=_ceil_to(moe.n_experts, tp))
        changes["moe"] = moe
    return dataclasses.replace(cfg, **changes) if changes else cfg


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(moe.n_experts, 8),
                                  top_k=min(moe.top_k, 2), d_ff_expert=64,
                                  n_experts_padded=0)
    hybrid = cfg.hybrid
    rwkv = cfg.rwkv
    if rwkv is not None:
        rwkv = dataclasses.replace(rwkv, head_size=16, decay_lora=8,
                                   gate_lora=16)
    n_layers = 2 if hybrid is None else cfg.hybrid.group_size
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=n_layers, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, d_head=16,
        moe=moe, hybrid=hybrid, rwkv=rwkv,
        n_heads_padded=0, n_kv_heads_padded=0, vocab_padded=0)
