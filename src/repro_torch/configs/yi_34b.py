"""yi-34b — Yi 34B (arXiv:2403.04652; hf) [dense].

60L d_model=7168, 56 heads GQA kv=8 (head_dim 128), d_ff=20480, vocab=64000.
llama-architecture with SwiGLU.  56 q heads pad to 64 / kv to 16 for TP=16
(function-preserving zero weights; `models.config.pad_for_tp`).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, d_head=128,
)
