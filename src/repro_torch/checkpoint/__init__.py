"""Atomic, async checkpointing of the port's state dicts."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager, latest_step, restore, save)
