"""pixtral-12b — Pixtral 12B (hf:mistralai/Pixtral-12B-2409; unverified) [vlm].

Backbone only (task spec): mistral-nemo-style decoder, 40L d_model=5120,
32 heads GQA kv=8 (head_dim 128), d_ff=14336, vocab=131072.  The pixtral-ViT
frontend is a STUB — input_specs() supplies precomputed patch embeddings
(B, S, d_model) in place of token embeddings.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, d_head=128,
    frontend="patch_stub",
)
