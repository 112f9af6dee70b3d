"""qwen3-moe-235b-a22b — Qwen3 235B-A22B MoE (hf:Qwen/Qwen3-30B-A3B family;
hf) [moe].

94L d_model=4096, 64 heads GQA kv=4 (head_dim 128), MoE 128 experts top-8
with d_ff_expert=1536, vocab=151936.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, d_head=128,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
)
