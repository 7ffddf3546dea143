"""Optimizer substrate (counterpart of ``repro.optim``): AdamW with f32
master weights over an ordered dict of named tensors, global-norm
clipping, the warmup-cosine schedule.  Gradient compression
(``optim/compression.py``) comes with tensor-parallel training."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "warmup_cosine"]
