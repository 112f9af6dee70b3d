"""The LM stack's dense family in PyTorch: `config` (the JAX package's
model configurations), `layers`, `model` (`UniformLM`, `init_params`,
`forward`, `decode_step`) and `interop` (carrying JAX parameters over)."""
