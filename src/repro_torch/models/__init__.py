"""Model substrate of the port: the dense GQA family, every projection a
SparseLinear."""

from repro_torch.models.config import ArchConfig, param_count
from repro_torch.models.transformer import (DenseLM, convert_to_compressed,
                                            decode_step, init_caches,
                                            init_model, prefill,
                                            weight_stream_bytes)

__all__ = ["ArchConfig", "param_count", "DenseLM", "convert_to_compressed",
           "decode_step", "init_caches", "init_model", "prefill",
           "weight_stream_bytes"]
