"""gemma2-9b [dense] — 42L d3584 16H (GQA kv=8) dff14336 v256000; local+global
alternating (window 4096), attn softcap 50 / final softcap 30, gelu,
zero-centered RMSNorm, pre+post norms, sqrt(d)-scaled embeddings.
[arXiv:2408.00118; hf; same values as the reference config]"""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv=8, d_ff=14336,
        vocab=256000, head_dim=256, rope_theta=10000.0, act="gelu",
        tie_embeddings=True,
        local_global_period=2, window=4096,
        softcap_attn=50.0, softcap_final=30.0,
        scale_embeds=True, post_norms=True, gemma_norm=True,
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=8,
        serve_layout="tp",
    )
