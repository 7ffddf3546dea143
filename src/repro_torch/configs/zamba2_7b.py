"""zamba2-7b [hybrid] — 81L d3584, Mamba2 blocks (state 64, d_inner 7168,
112 heads) + one SHARED attention+MLP block (32H MHA of 112, d_ff 14336)
applied after every 6 mamba blocks; v32000.  [arXiv:2411.15242; same
values as the reference config]

As in the reference, the shared block attends over a 4096-token sliding
window and is applied as a plain residual block (Zamba2's concatenated
input is simplified away)."""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336,
        vocab=32000, head_dim=112, rope_theta=10000.0,
        ssm_state=64, d_inner=7168, mamba_version=2, ssm_heads=112,
        conv_kernel=4, attn_period=6, window=4096, ssm_chunk=64,
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=8,
    )
