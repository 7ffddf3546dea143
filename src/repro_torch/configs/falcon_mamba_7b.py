"""falcon-mamba-7b [ssm] — 64L d4096 attention-free Mamba1 (state 16,
d_inner 8192, dt_rank 256, conv 4) v65024.  [arXiv:2410.05355; same values
as the reference config]

Its decode tick is a stream of sparse matvecs (in / x / dt / out
projections) against an O(1) state: the nm_spmv (vindexmac) path alone."""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv=0, d_ff=0,
        vocab=65024, head_dim=None,
        ssm_state=16, d_inner=8192, dt_rank=256, conv_kernel=4,
        mamba_version=1, ssm_chunk=32,
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=8,
    )
