"""Checkpoints of the port (counterpart of ``repro/checkpoint``), in the
reference's on-disk format."""
from .ckpt import (CheckpointManager, atomic_write_text, committed_steps,
                   latest_step, publish_dir, restore_checkpoint,
                   save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step", "committed_steps", "atomic_write_text",
           "publish_dir"]
