"""musicgen-medium — MusicGen Medium (arXiv:2306.05284; hf) [audio].

Decoder-only over EnCodec tokens: 48L d_model=1536, 24 heads (kv=24 — full
MHA), d_ff=6144, vocab=2048 (per-codebook).  The EnCodec frontend and the
4-codebook delay pattern are STUBS — input_specs() supplies precomputed
frame embeddings (B, S, d_model).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048, d_head=64,
    mlp="relu2",  # approximates musicgen's non-gated 2-matrix FFN
    frontend="frame_stub", rope_theta=1e4,
)
