"""nemotron-4-15b — Nemotron-4 15B (arXiv:2402.16819; unverified) [dense].

32L d_model=6144, 48 heads GQA kv=8 (head_dim 128), d_ff=24576,
vocab=256000.  Squared-ReLU MLP (no gate), large multilingual vocab.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=24576, vocab=256000, d_head=128,
    mlp="relu2", rope_theta=1e4,
)
