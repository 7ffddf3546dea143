"""deepseek-v2-lite-16b [moe] — 27L d2048 16H, MLA (kv_lora 512, qk 128+64
nope+rope, v 128), MoE 64 routed experts top-6 + 2 shared, expert dff 1408,
first layer dense (d_ff 10944), v102400.
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite; same values as the
reference config]"""

from repro_torch.core.sparse_matmul import SparsityConfig
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=10944,
        vocab=102400, rope_theta=10000.0,
        mla=True, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=64, top_k=6, n_shared_experts=2, moe_dff=1408,
        first_dense_layers=1, capacity_factor=1.25,
        sparsity=SparsityConfig(n=2, m=4, mode="srste"),
        grad_accum=4,
    )
