"""Optimizer substrate (counterpart of ``repro.optim``): AdamW with f32
master weights over an ordered dict of named tensors, global-norm
clipping, the warmup-cosine schedule, and the compressed gradient
all-reduce (``optim/compression.py``)."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.compression import (compress_bf16, compressed_grad_psum,
                                           compressed_psum, dequantize_int8,
                                           quantize_int8)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_bf16", "compressed_grad_psum", "compressed_psum",
           "dequantize_int8", "quantize_int8", "warmup_cosine"]
