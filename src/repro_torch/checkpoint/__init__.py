"""Checkpoints with atomic publish, in the JAX package's on-disk layout."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
