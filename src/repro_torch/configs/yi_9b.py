"""yi-9b — Yi 9B (arXiv:2403.04652; hf) [dense].

48L d_model=4096, 32 heads GQA kv=4 (head_dim 128), d_ff=11008, vocab=64000.
Depth-upscaled Yi-6B; llama architecture with SwiGLU.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense", n_layers=48, d_model=4096,
    n_heads=32, n_kv_heads=4, d_ff=11008, vocab=64000, d_head=128,
)
