"""mistral-large-123b [dense] — 88L d12288 96H (GQA kv=8) dff28672 v32768.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified; same values as the
reference config]"""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b", family="dense",
        n_layers=88, d_model=12288, n_heads=96, n_kv=8, d_ff=28672,
        vocab=32768, head_dim=128, rope_theta=1e6,
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=16,
        remat_group=11,
    )
