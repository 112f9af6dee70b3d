"""jamba-1.5-large-398b — Jamba 1.5 Large (arXiv:2403.19887; hf) [hybrid].

72L d_model=8192: Mamba+attention 1:7 interleave (9 groups of 7 Mamba +
1 attention; 64 heads GQA kv=8, head_dim 128), MoE 16 experts top-2 on
every other layer, d_ff=24576, vocab=65536.  Totals ~398B params / ~94B
active (verified analytically in tests).
"""
from ..models.config import HybridConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536, d_head=128,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    hybrid=HybridConfig(group_size=8, d_state=16, d_conv=4, expand=2),
)
