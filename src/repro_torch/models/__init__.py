"""Model substrate of the port: the dense GQA family and the MoE family
with MLA attention, every projection a SparseLinear."""

from repro_torch.models.config import ArchConfig, param_count
from repro_torch.models.transformer import (DenseLM, MoELM,
                                            convert_to_compressed,
                                            decode_step, init_caches,
                                            init_model, prefill,
                                            weight_stream_bytes)

__all__ = ["ArchConfig", "param_count", "DenseLM", "MoELM",
           "convert_to_compressed",
           "decode_step", "init_caches", "init_model", "prefill",
           "weight_stream_bytes"]
