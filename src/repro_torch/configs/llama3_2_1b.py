"""llama3.2-1b [dense] — 16L d2048 32H (GQA kv=8) dff8192 v128256.
[hf:meta-llama/Llama-3.2-1B; same values as the reference config]"""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv=8, d_ff=8192,
        vocab=128256, head_dim=64, rope_theta=500000.0, tie_embeddings=True,
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=4,
        serve_layout="tp",
    )
