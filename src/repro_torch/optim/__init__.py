"""AdamW, global-norm clipping and learning-rate schedules for the port."""

from .adamw import AdamWState, adamw_init, adamw_step, clip_by_global_norm
from .schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_step", "clip_by_global_norm", "cosine_schedule",
           "linear_warmup_cosine"]
