"""Checkpointing (counterpart of ``repro.checkpoint``): atomic, async,
self-describing checkpoints of the training state."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
