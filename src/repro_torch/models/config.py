"""Architecture configuration schema (counterpart of ``repro.models.config``).

The port covers the dense GQA family and the MoE family with MLA attention
(deepseek-v2-lite), so the schema carries the fields those read; the SSM /
enc-dec fields arrive with their families.  ``reduced()`` derives the CPU
smoke-test variant exactly as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.sparse_matmul import SparsityConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"
    window: Optional[int] = None
    local_global_period: Optional[int] = None
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    mla: bool = False
    # paged-decode attention read: 'gather' copies each slot's blocks back
    # into position order before the math (the oracle); 'fused' walks the
    # block table inside the paged_gqa_decode / paged_mla_decode kernel
    attn_impl: str = "gather"
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_dff: Optional[int] = None            # expert hidden (ds-v2: 1408)
    dense_residual: bool = False             # arctic: dense MLP in parallel
    first_dense_layers: int = 0              # ds-v2: layer 0 dense
    capacity_factor: float = 1.25
    input_mode: str = "tokens"               # tokens (this slice)
    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)
    dtype: str = "bfloat16"
    q_chunk: int = 512
    kv_chunk: int = 1024

    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 4),
            d_model=256,
            n_heads=4,
            n_kv=min(self.n_kv, 4) if self.n_kv else 0,
            d_ff=512,
            vocab=512,
            head_dim=64,
            dtype="float32",
            q_chunk=64, kv_chunk=64,
            sparsity=dataclasses.replace(self.sparsity, min_dim=64),
        )
        if self.n_experts:
            kw.update(n_experts=8, top_k=min(self.top_k, 2),
                      moe_dff=128 if self.moe_dff else None,
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.mla:
            kw.update(kv_lora=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
        if self.window:
            kw.update(window=32)
        if self.local_global_period:
            kw.update(local_global_period=2)
        return dataclasses.replace(self, **kw)


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of a dense- or MoE-family model (embeddings counted twice
    unless tied).  ``active_only`` counts the experts one token runs
    (top_k routed + shared) instead of all of them."""
    d, dff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd, H, KV = cfg.hd(), cfg.n_heads, cfg.n_kv
    total = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)

    def attn_params() -> int:
        if cfg.mla:
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            return (d * H * qk                       # wq
                    + d * (cfg.kv_lora + cfg.qk_rope_dim)
                    + cfg.kv_lora * H * (cfg.qk_nope_dim + cfg.v_head_dim)
                    + H * cfg.v_head_dim * d)
        return d * hd * (H + 2 * KV) + H * hd * d

    def mlp_params(hidden: int) -> int:
        return 3 * d * hidden if cfg.act == "silu" else 2 * d * hidden

    if cfg.family == "dense":
        return int(total + L * (attn_params() + mlp_params(dff)))
    if cfg.family != "moe":
        raise NotImplementedError(f"param_count for family {cfg.family!r} "
                                  f"comes with that family's port")
    moe_dff = cfg.moe_dff or dff
    e_count = (cfg.top_k + cfg.n_shared_experts) if active_only else \
        (cfg.n_experts + cfg.n_shared_experts)
    per_layer = attn_params() + e_count * mlp_params(moe_dff) \
        + d * cfg.n_experts                          # router
    if cfg.dense_residual:
        per_layer += mlp_params(dff)
    nd = cfg.first_dense_layers
    total += nd * (attn_params() + mlp_params(dff)) + (L - nd) * per_layer
    return int(total)
