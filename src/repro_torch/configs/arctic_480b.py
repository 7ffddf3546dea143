"""arctic-480b [moe] — 35L d7168 56H (GQA kv=8) dff4864 v32000;
MoE 128 experts top-2 with a parallel dense-residual MLP per layer.
[hf:Snowflake/snowflake-arctic-base; hf; same values as the reference
config]

Expert weights dominate the parameter bytes (~466B of 480B)."""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
        vocab=32000, head_dim=128, rope_theta=10000.0,
        n_experts=128, top_k=2, dense_residual=True,
        capacity_factor=1.25,
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=16,
        remat_group=7,
    )
