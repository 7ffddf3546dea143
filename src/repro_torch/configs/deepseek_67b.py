"""deepseek-67b [dense] — 95L d8192 64H (GQA kv=8) dff22016 v102400
(llama-arch). [arXiv:2401.02954; hf; same values as the reference config]"""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-67b", family="dense",
        n_layers=95, d_model=8192, n_heads=64, n_kv=8, d_ff=22016,
        vocab=102400, head_dim=128, rope_theta=10000.0,
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=16,
        remat_group=19,
    )
