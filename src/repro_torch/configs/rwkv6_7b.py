"""rwkv6-7b — RWKV-6 "Finch" 7B (arXiv:2404.05892; hf) [ssm].

32L d_model=4096, attention-free (64 heads x head_size 64), d_ff=14336,
vocab=65536.  Data-dependent decay time mixing; O(1)-state decode.
"""
from ..models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, d_ff=14336, vocab=65536, d_head=64,
    mixer="rwkv6", rwkv=RWKVConfig(head_size=64, decay_lora=64, gate_lora=128),
)
