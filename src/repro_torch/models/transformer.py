"""Model assembly for the dense family (counterpart of the dense half of
``repro.models.transformer``).

The reference scans over stacked per-layer params; here a ``DenseLM``
holds one ``DenseBlock`` module per layer and the stack is a Python loop.
Decode caches keep the reference's stacked layout, one tensor per leaf with
the layer axis first (paged pools: [L, n_blocks, block_size, kv, hd]), and
each layer reads and writes its slice in place.

Public API:
  init_model(cfg, seed, device)                  -> DenseLM
  init_caches(cfg, batch, max_len, device)       -> {"k", "v"} [L, B, S, kv, hd]
  prefill(model, cfg, batch, logit_pos)          -> (logits [B, V], caches)
  decode_step(model, cfg, caches, tokens, pos, block_table, attn_impl)
                                                 -> (logits [B, V], caches)
  convert_to_compressed(model, cfg)              -> DenseLM
  weight_stream_bytes(model, cfg)                -> dict
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import layers as sparse_layers
from repro_torch.core.layers import SparseLinear
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (Embedding, RMSNorm, embed_apply,
                                       embed_init, linear_weight_bytes,
                                       lm_head_apply, rms_norm, rms_norm_init)
from repro_torch.models.config import ArchConfig


class DenseBlock(nn.Module):
    def __init__(self, ln1: RMSNorm, attn_: attn.GQA, ln2: RMSNorm,
                 mlp: ffn_mod.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn_, ln2, mlp


class DenseLM(nn.Module):
    """Token embedding (tied LM head), dense blocks, final norm."""

    def __init__(self, embed: Embedding, layers: List[DenseBlock],
                 lnf: RMSNorm):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.lnf = lnf


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.local_global_period:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' with local/global layers' if cfg.local_global_period else ''}"
            f" comes with a later slice of the port (dense GQA only so far)")


def _norm(p: RMSNorm, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return rms_norm(p, x, cfg.norm_eps)


def _dense_block_init(gen, cfg: ArchConfig, dtype, device) -> DenseBlock:
    return DenseBlock(rms_norm_init(cfg.d_model, device),
                      attn.gqa_init(gen, cfg, dtype, device),
                      rms_norm_init(cfg.d_model, device),
                      ffn_mod.mlp_init(gen, cfg, dtype, device))


def _dense_block_apply(p: DenseBlock, x, cfg: ArchConfig, *, positions,
                       window=None, cache=None, cache_pos=None,
                       block_table=None, return_kv=False):
    a, new_cache = attn.gqa_apply(p.attn, _norm(p.ln1, x, cfg), cfg,
                                  positions=positions, window=window,
                                  cache=cache, cache_pos=cache_pos,
                                  block_table=block_table,
                                  return_kv=return_kv)
    x = x + a
    h = ffn_mod.mlp_apply(p.mlp, _norm(p.ln2, x, cfg), cfg)
    return x + h, new_cache


def init_model(cfg: ArchConfig, seed: int = 0, device="cuda") -> DenseLM:
    """Random weights from one ``torch.Generator`` seeded with ``seed`` on
    ``device`` (numbers differ from the reference's jax.random init; parity
    tests carry JAX weights over with ``repro_torch.convert``)."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = cfg.tdtype()
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    blocks = [_dense_block_init(gen, cfg, dtype, device)
              for _ in range(cfg.n_layers)]
    return DenseLM(embed, blocks, rms_norm_init(cfg.d_model, device))


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device="cuda"
                ) -> Dict[str, torch.Tensor]:
    """Plain-layout decode caches {"k", "v"}: [L, batch, max_len, kv, hd]."""
    _check_family(cfg)
    one = attn.gqa_cache_init(cfg, batch, max_len, cfg.tdtype(), device)
    return {name: z.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * z.dim())
            for name, z in one.items()}


def prefill(p: DenseLM, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            logit_pos: Optional[int] = None):
    """Full-sequence forward over ``batch["tokens"]`` [B, S] that returns
    the per-layer caches {"k", "v"} [L, B, S, kv, hd] and only one
    position's logits [B, V] (f32): the last, or ``logit_pos`` (the
    bucketed-prefill hook for right-padded prompts)."""
    _check_family(cfg)
    x = embed_apply(p.embed, batch["tokens"])
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    ks, vs = [], []
    for lp in p.layers:
        x, kv = _dense_block_apply(lp, x, cfg, positions=positions,
                                   return_kv=True)
        ks.append(kv["k"])
        vs.append(kv["v"])
    x = _norm(p.lnf, x, cfg)
    xl = x[:, -1:] if logit_pos is None else x[:, logit_pos:logit_pos + 1]
    logits = lm_head_apply(p.embed, xl, cfg.softcap_final)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(p: DenseLM, cfg: ArchConfig, caches: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: torch.Tensor,
                block_table: Optional[torch.Tensor] = None,
                attn_impl: Optional[str] = None):
    """One token per slot: tokens [B], pos int32 [B] per-slot positions,
    block_table int32 [B, max_blocks] over the paged pools {"k", "v"}
    [L, n_blocks, block_size, kv, hd] -> (logits [B, V] f32, caches).

    The pools are updated **in place** (the returned ``caches`` is the
    argument).  ``attn_impl`` ('gather' | 'fused') overrides
    ``cfg.attn_impl`` for the paged read."""
    _check_family(cfg)
    if block_table is None:
        raise NotImplementedError("slotted decode caches come with a later "
                                  "slice of the port; pass a block_table")
    if attn_impl is not None and attn_impl != cfg.attn_impl:
        cfg = cfg.replace(attn_impl=attn_impl)
    x = embed_apply(p.embed, tokens[:, None])
    for i, lp in enumerate(p.layers):
        layer_cache = {name: leaf[i] for name, leaf in caches.items()}
        x, _ = _dense_block_apply(lp, x, cfg, positions=pos,
                                  cache=layer_cache,
                                  cache_pos=pos, block_table=block_table)
    x = _norm(p.lnf, x, cfg)
    logits = lm_head_apply(p.embed, x, cfg.softcap_final)[:, 0]
    return logits, caches


# ------------------------------------------------- compressed serving weights

def _map_linears(module: nn.Module, fn) -> nn.Module:
    """A copy of ``module`` with ``fn`` applied to every ``SparseLinear``;
    every other tensor is shared with the original (not copied)."""
    if isinstance(module, SparseLinear):
        return fn(module)
    new = copy.copy(module)
    new._modules = {name: _map_linears(child, fn)
                    for name, child in module._modules.items()}
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    return new


def _linears(module: nn.Module) -> List[SparseLinear]:
    return [m for m in module.modules() if isinstance(m, SparseLinear)]


def convert_to_compressed(p: DenseLM, cfg: ArchConfig) -> DenseLM:
    """Model-wide offline packing pass: every SparseLinear the sparsity
    policy applies to moves to the compressed N:M serving format; norms and
    the embedding are shared with ``p``, which is left unchanged."""
    sp = cfg.sparsity
    return _map_linears(p, lambda q: sparse_layers.convert_to_compressed(q, sp))


def weight_stream_bytes(p: DenseLM, cfg: ArchConfig) -> Dict[str, float]:
    """Decode weight-stream accounting: every decode step reads each linear
    once, so per-step traffic is the sum of their stored bytes — values
    plus packed ceil(log2 M)-bit indices for converted leaves, the dense
    weight otherwise (embedding and norms excluded on both sides).  The
    ``*_linears`` counts are per layer (the reference counts a stacked
    [L, ...] leaf once)."""
    tot = {"dense_bytes": 0, "stream_bytes": 0,
           "compressed_linears": 0, "dense_linears": 0}
    for lin in _linears(p):
        d, s = linear_weight_bytes(lin, cfg.sparsity)
        tot["dense_bytes"] += d
        tot["stream_bytes"] += s
        tot["compressed_linears" if lin.compressed else "dense_linears"] += 1
    tot["ratio"] = tot["stream_bytes"] / max(tot["dense_bytes"], 1)
    return tot
