"""qwen2-vl-7b [vlm] — 28L d3584 28H (GQA kv 4, head 128) dff18944
v152064, rope theta 1e6, qkv bias.  [arXiv:2409.12191; same values as the
reference config]

As in the reference, the vision tower is a stub: a request carries
precomputed patch + text embeddings ``embeds`` [S, d] (``input_mode=
"embeds"``), and M-RoPE's (t, h, w) sections degenerate to 1-D RoPE on
that stream.  Generated tokens go through the token embedding."""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv=4, d_ff=18944,
        vocab=152064, head_dim=128, rope_theta=1e6, qkv_bias=True,
        input_mode="embeds",
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=8,
        serve_layout="tp",
        remat_group=7,
    )
