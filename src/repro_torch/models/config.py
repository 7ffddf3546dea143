"""Architecture configuration schema (counterpart of ``repro.models.config``).

This slice of the port covers the dense GQA family, so the schema carries
the fields that family reads; the MoE / SSM / MLA / enc-dec fields arrive
with their families.  ``reduced()`` derives the CPU smoke-test variant
exactly as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.sparse_matmul import SparsityConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense (this slice)
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
    # paged-decode attention read: 'gather' copies each slot's blocks back
    # into position order before the math (the oracle); 'fused' walks the
    # block table inside the paged_gqa_decode kernel
    attn_impl: str = "gather"
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
        if self.window:
            kw.update(window=32)
        if self.local_global_period:
            kw.update(local_global_period=2)
        return dataclasses.replace(self, **kw)


def param_count(cfg: ArchConfig) -> int:
    """Parameters of a dense-family model (embeddings counted twice unless
    tied)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"param_count for family {cfg.family!r} "
                                  f"comes with that family's port")
    d, dff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd, H, KV = cfg.hd(), cfg.n_heads, cfg.n_kv
    total = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    attn = d * hd * (H + 2 * KV) + H * hd * d
    mlp = 3 * d * dff if cfg.act == "silu" else 2 * d * dff
    return int(total + L * (attn + mlp))
