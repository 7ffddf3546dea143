"""Model substrate of the port: the dense GQA family (and the vlm family,
the same blocks over precomputed embeddings), the MoE family with MLA
attention, the SSM family (Mamba1), the hybrid family (Mamba2 with a
shared attention block) and the audio family (an encoder-decoder with
cross-attention), every projection a SparseLinear;
``models.cnn`` holds the sparse CNN layers (convolution as an N:M
GEMM)."""

from repro_torch.models.config import ArchConfig, param_count
from repro_torch.models.transformer import (DenseLM, EncDecLM, HybridLM,
                                            MoELM, SSMLM, bind_params,
                                            convert_to_compressed,
                                            decode_ring_bytes, gather_model,
                                            decode_step, forward, init_caches,
                                            init_model, loss_fn, make_draft,
                                            param_shard_specs, prefill,
                                            serve_ring_traffic_bytes,
                                            shard_for_training,
                                            shard_model, train_shard_specs,
                                            verify_step,
                                            weight_stream_bytes)

__all__ = ["ArchConfig", "param_count", "DenseLM", "EncDecLM", "HybridLM",
           "MoELM",
           "SSMLM",
           "bind_params", "convert_to_compressed", "decode_ring_bytes",
           "decode_step", "forward",
           "gather_model", "init_caches", "init_model", "loss_fn",
           "make_draft", "param_shard_specs", "prefill",
           "serve_ring_traffic_bytes", "shard_for_training", "shard_model",
           "train_shard_specs", "verify_step", "weight_stream_bytes"]
