"""Architecture configuration schema (counterpart of ``repro.models.config``).

The port covers every family of the reference: the dense GQA family
(gemma2's local / global pairs included), the vlm family (dense blocks
over precomputed embeddings), the MoE family with GQA or MLA attention,
the SSM family (Mamba1), the hybrid family (Mamba2 groups with a shared
attention block) and the audio family (an encoder-decoder with
cross-attention).  ``reduced()`` derives the CPU smoke-test variant
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
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
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
    window: Optional[int] = None             # sliding window (local layers)
    local_global_period: Optional[int] = None  # gemma2: alternate local/global
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    scale_embeds: bool = False               # gemma: x *= sqrt(d)
    post_norms: bool = False                 # gemma2: post-sublayer norms
    gemma_norm: bool = False                 # zero-centered RMSNorm scale
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
    # --- SSM ---
    ssm_state: int = 0
    d_inner: Optional[int] = None            # default 2*d_model
    conv_kernel: int = 4
    dt_rank: Optional[int] = None            # mamba1; default ceil(d/16)
    mamba_version: int = 1
    ssm_heads: Optional[int] = None          # mamba2
    attn_period: int = 0                     # zamba2: shared attn every k
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 1500
    n_mels: int = 80
    # --- input mode ---
    input_mode: str = "tokens"               # tokens | embeds (vlm)
    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)
    dtype: str = "bfloat16"
    q_chunk: int = 512
    kv_chunk: int = 1024
    ssm_chunk: int = 64
    # chunked attention keeps its [q_chunk, kv_chunk] score and probability
    # tiles in bf16 (the statistics and accumulations stay f32)
    attn_chain_bf16: bool = False
    # --- training: per-block activation checkpointing; remat_group G
    # checkpoints G groups of L/G blocks, each block inside its group too,
    # keeping G + L/G block boundaries instead of L (0 = per-block only) ---
    remat: bool = True
    remat_group: int = 0
    grad_accum: int = 1                      # microbatches per step

    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def dinner(self) -> int:
        return self.d_inner or 2 * self.d_model

    def dtrank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    def nheads_ssm(self) -> int:
        """Mamba2's head count (the reference's ``ssm_heads or
        d_inner // 64``)."""
        return self.ssm_heads or self.dinner() // 64

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
            q_chunk=64, kv_chunk=64, ssm_chunk=16,
            sparsity=dataclasses.replace(self.sparsity, min_dim=64),
        )
        if self.n_experts:
            kw.update(n_experts=8, top_k=min(self.top_k, 2),
                      moe_dff=128 if self.moe_dff else None,
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.ssm_state:
            kw.update(ssm_state=8, d_inner=512,
                      ssm_heads=8 if self.ssm_heads else None,
                      dt_rank=16 if self.mamba_version == 1 else None,
                      attn_period=2 if self.attn_period else 0)
        if self.mla:
            kw.update(kv_lora=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
        if self.enc_layers:
            kw.update(enc_layers=2, enc_seq=64)
        if self.window:
            kw.update(window=32)
        if self.local_global_period:
            kw.update(local_global_period=2)
        return dataclasses.replace(self, **kw)


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of a model by the reference's formula (embeddings counted
    twice unless tied).  ``active_only`` counts the experts one token runs
    (top_k routed + shared) instead of all of them.  The hybrid family
    counts its shared attention block once; the audio family its encoder
    and decoder blocks, one cross-attention per decoder block and the conv
    frontend stub."""
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

    if cfg.family in ("dense", "vlm"):
        return int(total + L * (attn_params() + mlp_params(dff)))
    if cfg.family == "audio":
        total += (cfg.enc_layers + L) * (attn_params() + mlp_params(dff))
        total += L * attn_params()                     # cross-attention
        total += cfg.n_mels * d * 3 * 2                # conv frontend stub
        return int(total)
    if cfg.family == "ssm":
        di, st, dtr = cfg.dinner(), cfg.ssm_state, cfg.dtrank()
        per = (d * 2 * di + di * cfg.conv_kernel + di * (dtr + 2 * st)
               + dtr * di + di * st + di + di * d)
        return int(total + L * per)
    if cfg.family == "hybrid":
        di, st, nh = cfg.dinner(), cfg.ssm_state, cfg.nheads_ssm()
        # mamba2 block: packed in_proj (x, z, B, C, dt) + conv + out_proj
        per = (d * (2 * di + 2 * st + nh) + di * cfg.conv_kernel
               + 3 * nh + di + di * d)
        total += L * per
        if cfg.attn_period:
            total += attn_params() + mlp_params(dff)   # shared block (once)
        return int(total)
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
