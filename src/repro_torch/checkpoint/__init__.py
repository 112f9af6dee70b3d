"""Compressed, checksummed, atomic checkpoints of the LM's parameters and
optimizer state (`manager`), in the JAX package's format."""
from .manager import CheckpointConfig, CheckpointManager

__all__ = ["CheckpointConfig", "CheckpointManager"]
