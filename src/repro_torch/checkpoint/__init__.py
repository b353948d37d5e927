"""Checkpoints in the reference's layout (torch port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, restore, restore_sharded, save)
