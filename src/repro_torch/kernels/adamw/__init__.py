"""The multi-tensor AdamW step (CUDA) and its plain version."""

from .ops import adamw_step, build, reset_counts
from .ref import adamw_step_ref

__all__ = ["adamw_step", "adamw_step_ref", "build", "reset_counts"]
