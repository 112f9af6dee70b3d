"""The LM stack in PyTorch: `config` (the JAX package's model
configurations), `layers` (with MoE and `chunked_scan`), `mamba`, `rwkv`,
`model` (`UniformLM`, `HybridLM`, `init_params`, `forward`,
`decode_step`) and `interop` (carrying JAX parameters over)."""
