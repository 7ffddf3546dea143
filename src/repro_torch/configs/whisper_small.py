"""whisper-small [audio] — encoder-decoder, 12 layers each side, d768 12H
(kv 12, head 64) dff3072, gelu, qkv bias, v51865.  [arXiv:2212.04356;
same values as the reference config]

As in the reference, the conv frontend is a stub: a request carries
precomputed log-mel frame embeddings ``enc_embeds`` [enc_seq 1500, d],
the encoder has no RoPE and attends without a mask, and each decoder
block cross-attends over its projection of the encoder output."""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small", family="audio",
        n_layers=12, enc_layers=12, d_model=768, n_heads=12, n_kv=12,
        d_ff=3072, vocab=51865, head_dim=64, act="gelu", qkv_bias=True,
        enc_seq=1500, n_mels=80,
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=2,
        remat_group=4,
    )
