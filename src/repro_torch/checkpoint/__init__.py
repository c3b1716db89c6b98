"""NeurStore-backed delta-compressed checkpointing."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
