"""Model substrate of the port: the dense GQA family and the MoE family
with MLA attention, every projection a SparseLinear; ``models.cnn`` holds
the sparse CNN layers (convolution as an N:M GEMM)."""

from repro_torch.models.config import ArchConfig, param_count
from repro_torch.models.transformer import (DenseLM, MoELM,
                                            convert_to_compressed,
                                            decode_step, forward, init_caches,
                                            init_model, loss_fn, make_draft,
                                            prefill, verify_step,
                                            weight_stream_bytes)

__all__ = ["ArchConfig", "param_count", "DenseLM", "MoELM",
           "convert_to_compressed", "decode_step", "forward", "init_caches",
           "init_model", "loss_fn", "make_draft", "prefill", "verify_step",
           "weight_stream_bytes"]
