"""granite-moe-3b-a800m — IBM Granite 3.0 3B-A800M MoE
(hf:ibm-granite/granite-3.0-1b-a400m-base family; hf) [moe].

32L d_model=1536, 24 heads GQA kv=8 (head_dim 64), MoE 40 experts top-8
with d_ff_expert=512, vocab=49155.  40 experts pad to 48 and vocab to
49168 for TP=16 (function-preserving; `models.config.pad_for_tp`).
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155, d_head=64,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
)
