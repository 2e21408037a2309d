"""Atomic, async, keep-k checkpoints in the reference's on-disk layout."""

from .manager import CheckpointManager, latest_step, restore_pytree, save_pytree

__all__ = ["CheckpointManager", "latest_step", "restore_pytree", "save_pytree"]
