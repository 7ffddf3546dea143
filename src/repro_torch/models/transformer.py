"""Model assembly for every family (counterpart of
``repro.models.transformer``).

The reference scans over stacked per-layer params; here a ``DenseLM``
holds one ``DenseBlock`` module per layer, a ``MoELM`` its
``first_dense_layers`` dense blocks then its ``MoEBlock``s, and the stack
is a Python loop.  A block's attention is GQA, or MLA when ``cfg.mla``.
gemma2's local / global pairs (``cfg.local_global_period``; the reference
scans over stacked pairs) are the same flat list: block 2i is local (its
attention keeps the last ``cfg.window`` positions), block 2i + 1 global;
``post_norms`` adds a norm after each sublayer, ``gemma_norm`` scales the
norms by ``1 + scale`` and ``scale_embeds`` multiplies the embedding by
sqrt(d) (cast to its dtype first, as the reference does).

Decode caches keep the reference's stacked layout, one tensor per leaf
with the layer axis first (slotted: GQA {"k", "v"} [L, B, max_len, kv,
hd], MLA {"ckv", "kpe"} [L, B, max_len, kv_lora | rope]; paged pools:
[L, n_blocks, block_size, ...]), and each layer reads and writes its slice
in place.  gemma2's slotted caches are {"local": {"k", "v"}, "global":
{"k", "v"}}, each [L / 2, B, ...]: a local layer keeps a ring of
``min(max_len, window)`` positions, a global one ``max_len``.  Its paged
pool (``init_caches(..., ring=False)``) is one [L, ...] stack like any
other: local layers go through the block table too, the window a read
mask.

The SSM family (falcon-mamba, ``SSMLM``) is a flat list of Mamba1
blocks; the hybrid (zamba2, ``HybridLM``) holds ``groups`` of
``attn_period`` Mamba2 blocks, **one** shared ``DenseBlock`` applied after
every group (attention over ``cfg.window``), and a ``tail`` of the
remaining blocks.  Their caches keep the reference's layout: SSM {"h",
"conv"} [L, B, ...]; hybrid {"groups": {"h", "conv"} [G, P, B, ...],
"attn": {"k", "v"} [G, B, len, ...] (one KV cache per application of
the shared block), "tail": {"h", "conv"} [T, B, ...]}.  The state leaves
have no sequence axis: in the paged pool they stay one row per slot,
and only "attn" goes through the block table.

The vlm family (qwen2-vl) is the dense family fed precomputed embeddings:
``forward`` and ``prefill`` take ``batch["embeds"]`` [B, S, d] in place
of tokens (``_embed_in``), and decode embeds its generated tokens.  The
audio family (whisper, ``EncDecLM``) encodes ``batch["enc_embeds"]`` [B,
Se, d] through ``EncBlock``s (no RoPE, no mask) and a final norm; each
``DecBlock`` runs causal self-attention, cross-attention over its own
projection of the encoder output, then the gated MLP, each after its own
norm.  Its caches are {"self": {"k", "v"} [L, B, max_len, kv, hd],
"cross_k", "cross_v": [L, B, Se, kv, hd]}: the cross K/V, written by
prefill and only read by decode, have no sequence axis, so the paged pool
keeps them one row per slot beside the paged "self" leaves.

Under autograd (a parameter requires grad: the trainer's steps)
``forward`` checkpoints every block (``cfg.remat``; with
``cfg.remat_group`` G, also G groups of L / G blocks around them, the
reference's sqrt-remat, for the dense / MoE, SSM, encoder and decoder
stacks), each of the hybrid's groups with its shared block's application
around its Mamba blocks' own checkpoints, and ``chunked_attention`` each
kv step; a pass that records no graph runs the blocks plainly.

Public API (family-dispatched):
  init_model(cfg, seed, device)                  -> DenseLM | MoELM | SSMLM
                                                    | HybridLM | EncDecLM
  init_caches(cfg, batch, max_len, device, ring) -> {"k", "v"} | {"ckv", "kpe"}
                                                    | {"local", "global"}
                                                    | {"h", "conv"} | {"groups",
                                                    "attn", "tail"} | {"self",
                                                    "cross_k", "cross_v"}
  forward(model, cfg, batch)                     -> (logits [B, S, V], moe_aux)
  loss_fn(model, cfg, batch, aux_weight)         -> (loss, {"loss", "moe_aux"})
  prefill(model, cfg, batch, logit_pos)          -> (logits [B, V], caches)
  decode_step(model, cfg, caches, tokens, pos, block_table, attn_impl,
              layers)                            -> (logits [B, V], caches)
  verify_step(model, cfg, caches, tokens, pos, block_table, attn_impl)
                                                 -> (logits [B, S, V], caches)
  make_draft(model, cfg, kind, stride)           -> (draft, draft_cfg, cache_idx)
  convert_to_compressed(model, cfg)              -> the same model class
  weight_stream_bytes(model, cfg)                -> dict
  param_shard_specs(model)                       -> {name: logical spec}
  shard_model(model, mesh, rules)                -> the same model class,
                                                    each leaf its local shard
  serve_ring_traffic_bytes(model, cfg, ndev)     -> dict
  decode_ring_bytes(model, cfg, ndev)            -> int
  train_shard_specs(model)                       -> {name: logical spec}
  shard_for_training(model, mesh, rules)         -> (skeleton, {name:
                                                    LeafLayout})
  bind_params(skeleton, leaves)                  -> the skeleton's class
  gather_model(skeleton, layouts, mesh)          -> the whole model
  cache_specs(caches)                            -> {leaf: logical spec}
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import layers as sparse_layers
from repro_torch.core.layers import SparseLinear
from repro_torch.core.sparse_matmul import nm_rerank
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (Embedding, RMSNorm, cross_entropy,
                                       embed_apply, embed_init,
                                       linear_weight_bytes, lm_head_apply,
                                       rms_norm, rms_norm_init)
from repro_torch.models.config import ArchConfig


class DenseBlock(nn.Module):
    """Attention, then the gated MLP; ``pn1`` / ``pn2`` (``post_norms``)
    normalize each sublayer's output before its residual add."""

    def __init__(self, ln1: RMSNorm, attn_: Union[attn.GQA, attn.MLA],
                 ln2: RMSNorm, mlp: ffn_mod.MLP,
                 pn1: Optional[RMSNorm] = None,
                 pn2: Optional[RMSNorm] = None):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn_, ln2, mlp
        self.pn1, self.pn2 = pn1, pn2


class MoEBlock(nn.Module):
    """Attention, then the MoE FFN (plus a parallel dense MLP when
    ``cfg.dense_residual``)."""

    def __init__(self, ln1: RMSNorm, attn_: Union[attn.GQA, attn.MLA],
                 ln2: RMSNorm, moe: ffn_mod.MoE,
                 mlp: Optional[ffn_mod.MLP] = None):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.moe = ln1, attn_, ln2, moe
        self.mlp = mlp


class DenseLM(nn.Module):
    """Token embedding (tied LM head), dense blocks, final norm."""

    def __init__(self, embed: Embedding, layers: List[DenseBlock],
                 lnf: RMSNorm):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.lnf = lnf

    def blocks(self) -> List[nn.Module]:
        """Every block in depth order (decode cache layer i is block i)."""
        return list(self.layers)


class MoELM(nn.Module):
    """Token embedding (tied LM head), ``first_dense_layers`` dense blocks,
    MoE blocks, final norm."""

    def __init__(self, embed: Embedding, dense_layers: List[DenseBlock],
                 layers: List[MoEBlock], lnf: RMSNorm):
        super().__init__()
        self.embed = embed
        self.dense_layers = nn.ModuleList(dense_layers)
        self.layers = nn.ModuleList(layers)
        self.lnf = lnf

    def blocks(self) -> List[nn.Module]:
        """Every block in depth order (decode cache layer i is block i)."""
        return list(self.dense_layers) + list(self.layers)


class SSMBlock(nn.Module):
    """Pre-norm residual around one Mamba1 or Mamba2 mixer."""

    def __init__(self, ln: RMSNorm,
                 mixer: Union[ssm_mod.Mamba1, ssm_mod.Mamba2]):
        super().__init__()
        self.ln, self.mixer = ln, mixer


class SSMLM(nn.Module):
    """Token embedding (tied LM head), Mamba1 blocks, final norm."""

    def __init__(self, embed: Embedding, layers: List[SSMBlock],
                 lnf: RMSNorm):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.lnf = lnf


class HybridLM(nn.Module):
    """Token embedding (tied LM head), ``groups`` of Mamba2 blocks each
    followed by the one ``shared`` attention + MLP block, a ``tail`` of
    Mamba2 blocks, final norm.  ``shared`` is one module: its weights are
    read once per application but stored (and counted) once."""

    def __init__(self, embed: Embedding, groups: List[List[SSMBlock]],
                 shared: Optional[DenseBlock], tail: List[SSMBlock],
                 lnf: RMSNorm):
        super().__init__()
        self.embed = embed
        self.groups = nn.ModuleList(nn.ModuleList(g) for g in groups)
        self.shared = shared
        self.tail = nn.ModuleList(tail)
        self.lnf = lnf


class EncBlock(nn.Module):
    """Encoder block: unmasked self-attention without RoPE, then the gated
    MLP, each after its own norm."""

    def __init__(self, ln1: RMSNorm, attn_: attn.GQA, ln2: RMSNorm,
                 mlp: ffn_mod.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn_, ln2, mlp


class DecBlock(nn.Module):
    """Decoder block: causal self-attention (``attn``, the decode caches'
    "self"), cross-attention over the encoder's K/V, then the gated MLP,
    each after its own norm."""

    def __init__(self, ln1: RMSNorm, attn_: attn.GQA, ln2: RMSNorm,
                 cross: attn.GQA, ln3: RMSNorm, mlp: ffn_mod.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.cross = ln1, attn_, ln2, cross
        self.ln3, self.mlp = ln3, mlp


class EncDecLM(nn.Module):
    """Token embedding (the LM head reads it, as the reference's), encoder
    blocks with their final norm ``enc_lnf``, decoder blocks, final norm.
    The conv frontend is a stub: the encoder takes frame embeddings."""

    def __init__(self, embed: Embedding, enc_layers: List[EncBlock],
                 enc_lnf: RMSNorm, layers: List[DecBlock], lnf: RMSNorm):
        super().__init__()
        self.embed = embed
        self.enc_layers = nn.ModuleList(enc_layers)
        self.enc_lnf = enc_lnf
        self.layers = nn.ModuleList(layers)
        self.lnf = lnf

    def blocks(self) -> List[nn.Module]:
        """The decoder blocks (decode cache layer i is block i)."""
        return list(self.layers)


LM = Union[DenseLM, MoELM, SSMLM, HybridLM, EncDecLM]
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
STATE_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: unknown family "
                                  f"{cfg.family!r}")


def _norm(p: RMSNorm, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return rms_norm(p, x, cfg.norm_eps, zero_centered=cfg.gemma_norm)


def _window(cfg: ArchConfig, i: int) -> Optional[int]:
    """The attention window of block ``i``: gemma2's pairs are (local,
    global), as the reference's scan body runs them."""
    return cfg.window if cfg.local_global_period and i % 2 == 0 else None


def _embed(p, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return _scaled(embed_apply(p.embed, tokens), cfg)


def _embed_in(p, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
    """The first residual of a full-sequence pass: ``batch["embeds"]``
    cast to the model's dtype (the vlm family's precomputed embeddings)
    when the batch has them, else the token embedding."""
    if "embeds" in batch:
        return _scaled(batch["embeds"].to(cfg.tdtype()), cfg)
    return _embed(p, cfg, batch["tokens"])


def _scaled(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.scale_embeds:
        # sqrt(d) rounded to x's dtype first, as the reference does (59.75
        # in bf16 at d 3584); a host scalar, so no copy to the device
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def _attn_init(gen, cfg: ArchConfig, dtype, device):
    return (attn.mla_init(gen, cfg, dtype, device) if cfg.mla
            else attn.gqa_init(gen, cfg, dtype, device))


def _attn_apply(p, x, cfg: ArchConfig, **kw):
    if cfg.mla:
        return attn.mla_apply(p, x, cfg, **kw)
    return attn.gqa_apply(p, x, cfg, **kw)


def _dense_block_init(gen, cfg: ArchConfig, dtype, device) -> DenseBlock:
    post = ((rms_norm_init(cfg.d_model, device),
             rms_norm_init(cfg.d_model, device)) if cfg.post_norms else ())
    return DenseBlock(rms_norm_init(cfg.d_model, device),
                      _attn_init(gen, cfg, dtype, device),
                      rms_norm_init(cfg.d_model, device),
                      ffn_mod.mlp_init(gen, cfg, dtype, device), *post)


def _dense_block_apply(p: DenseBlock, x, cfg: ArchConfig, *, positions,
                       window=None, cache=None, cache_pos=None,
                       block_table=None, return_kv=False, step=None):
    kw = {} if cfg.mla else {"window": window}
    a, new_cache = _attn_apply(p.attn, _norm(p.ln1, x, cfg), cfg,
                               positions=positions, cache=cache,
                               cache_pos=cache_pos, block_table=block_table,
                               return_kv=return_kv, step=step, **kw)
    if p.pn1 is not None:
        a = _norm(p.pn1, a, cfg)
    x = x + a
    h = ffn_mod.mlp_apply(p.mlp, _norm(p.ln2, x, cfg), cfg)
    if p.pn2 is not None:
        h = _norm(p.pn2, h, cfg)
    return x + h, new_cache


def _moe_block_init(gen, cfg: ArchConfig, dtype, device) -> MoEBlock:
    return MoEBlock(rms_norm_init(cfg.d_model, device),
                    _attn_init(gen, cfg, dtype, device),
                    rms_norm_init(cfg.d_model, device),
                    ffn_mod.moe_init(gen, cfg, dtype, device),
                    ffn_mod.mlp_init(gen, cfg, dtype, device)
                    if cfg.dense_residual else None)


def _moe_block_apply(p: MoEBlock, x, cfg: ArchConfig, *, positions,
                     cache=None, cache_pos=None, block_table=None,
                     return_kv=False, step=None):
    a, new_cache = _attn_apply(p.attn, _norm(p.ln1, x, cfg), cfg,
                               positions=positions, cache=cache,
                               cache_pos=cache_pos, block_table=block_table,
                               return_kv=return_kv, step=step)
    x = x + a
    xn = _norm(p.ln2, x, cfg)
    h, aux = ffn_mod.moe_apply(p.moe, xn, cfg)
    if p.mlp is not None:
        h = h + ffn_mod.mlp_apply(p.mlp, xn, cfg)
    return x + h, new_cache, aux


def _block_apply(p, x, cfg: ArchConfig, window=None, **kw):
    """One block of either kind -> (x, new_cache); the MoE aux loss is a
    training signal and is dropped here (MoE blocks have no window)."""
    if isinstance(p, MoEBlock):
        return _moe_block_apply(p, x, cfg, **kw)[:2]
    return _dense_block_apply(p, x, cfg, window=window, **kw)


def _ssm_block_init(gen, cfg: ArchConfig, dtype, device) -> SSMBlock:
    init = ssm_mod.mamba1_init if cfg.mamba_version == 1 else \
        ssm_mod.mamba2_init
    return SSMBlock(rms_norm_init(cfg.d_model, device),
                    init(gen, cfg, dtype, device))


def _ssm_block_apply(p: SSMBlock, x, cfg: ArchConfig, cache=None,
                     return_state=False):
    mix = ssm_mod.mamba1_apply if cfg.mamba_version == 1 else \
        ssm_mod.mamba2_apply
    y, state = mix(p.mixer, _norm(p.ln, x, cfg), cfg, cache=cache,
                   return_state=return_state)
    return x + y, state


def _hybrid_layout(cfg: ArchConfig):
    """(groups, period, tail) of the hybrid stack, as the reference splits
    ``n_layers``: ``n_layers // period`` groups, the rest a tail."""
    period = cfg.attn_period or cfg.n_layers
    groups = cfg.n_layers // period
    return groups, period, cfg.n_layers - groups * period


def _state_cache_init(cfg: ArchConfig, batch: int, dtype, device):
    init = ssm_mod.mamba1_cache_init if cfg.mamba_version == 1 else \
        ssm_mod.mamba2_cache_init
    return init(cfg, batch, dtype, device)


def _stacked(one: Dict[str, torch.Tensor], *lead: int
             ) -> Dict[str, torch.Tensor]:
    return {name: z.reshape((1,) * len(lead) + tuple(z.shape))
            .repeat(tuple(lead) + (1,) * z.dim()).contiguous()
            for name, z in one.items()}


def _sub(tree: Dict[str, torch.Tensor], *idx: int) -> Dict[str, torch.Tensor]:
    """One layer's views of stacked leaves (written in place)."""
    return {name: leaf[idx] for name, leaf in tree.items()}


def _state_stack(p: LM, cfg: ArchConfig, x, positions):
    """The SSM or hybrid stack over x [B, S, d] without caches -> (x before
    the final norm, the prefill caches: SSM {"h", "conv"} [L, B, ...];
    hybrid {"groups": [G, P, B, ...], "attn": {"k", "v"} [G, B, S, ...],
    "tail": [T, B, ...]})."""

    def run(blocks):
        nonlocal x
        states = []
        for lp in blocks:
            x, st = _ssm_block_apply(lp, x, cfg, return_state=True)
            states.append(st)
        return states

    def stack(states):
        return {name: torch.stack([st[name] for st in states])
                for name in states[0]}

    if isinstance(p, SSMLM):
        states = run(p.layers)
        return x, stack(states)
    caches, gstates, kvs = {}, [], []
    for group in p.groups:
        gstates.append(run(group))
        x, kv = _dense_block_apply(p.shared, x, cfg, positions=positions,
                                   window=cfg.window, return_kv=True)
        kvs.append(kv)
    if gstates:
        per_group = [stack(g) for g in gstates]
        caches["groups"] = {name: torch.stack([g[name] for g in per_group])
                            for name in per_group[0]}
        caches["attn"] = {name: torch.stack([kv[name] for kv in kvs])
                          for name in kvs[0]}
    tail = run(p.tail)
    if tail:
        caches["tail"] = stack(tail)
    return x, caches


def _ssm_step(lp: SSMBlock, x, *, cfg: ArchConfig):
    return (_ssm_block_apply(lp, x, cfg)[0],)


def _state_forward(p: LM, cfg: ArchConfig, x, positions, *, remat: bool):
    """``forward``'s pass over the SSM or hybrid stack (no caches) -> x.
    Under ``remat`` every Mamba block is a checkpoint (the SSM stack also
    in ``cfg.remat_group`` groups), and each hybrid group, its shared
    block's application included, is one around its blocks' own, as the
    reference's ``_lm_hybrid_forward``."""

    def steps(blocks):
        return [functools.partial(_ssm_step, lp, cfg=cfg) for lp in blocks]

    if isinstance(p, SSMLM):
        return _stack_forward(steps(p.layers), (x,), cfg, remat=remat)[0]

    def group_step(group, x):
        (x,) = _stack_forward(steps(group), (x,), cfg, remat=remat,
                              grouped=False)
        x, _ = _dense_block_apply(p.shared, x, cfg, positions=positions,
                                  window=cfg.window)
        return (x,)

    fns = [functools.partial(group_step, group) for group in p.groups]
    (x,) = _stack_forward(fns, (x,), cfg, remat=remat, grouped=False)
    return _stack_forward(steps(p.tail), (x,), cfg, remat=remat,
                          grouped=False)[0]


def _state_cached(p: LM, cfg: ArchConfig, caches, x, pos, block_table,
                  layers=None):
    """The SSM or hybrid stack over one token per slot against the decode
    caches (updated in place) -> x before the final norm.  Mamba block i
    of an ``SSMLM`` uses cache layer ``layers[i]`` (a skip draft's
    ``cache_idx``), or i.  The shared block's application g reads and
    writes its own KV cache ``caches["attn"]`` [g] (slotted rings, or the
    paged pool through ``block_table``)."""
    if isinstance(p, SSMLM):
        for i, lp in enumerate(p.layers):
            li = i if layers is None else int(layers[i])
            x, _ = _ssm_block_apply(lp, x, cfg, cache=_sub(caches, li))
        return x
    step = None
    if block_table is not None and len(p.groups):
        step = attn.paged_step(cfg, pos, x.shape[1], block_table,
                               caches["attn"]["k"].shape[2])
    for g, group in enumerate(p.groups):
        for j, lp in enumerate(group):
            x, _ = _ssm_block_apply(lp, x, cfg,
                                    cache=_sub(caches["groups"], g, j))
        x, _ = _dense_block_apply(p.shared, x, cfg, positions=pos,
                                  window=cfg.window,
                                  cache=_sub(caches["attn"], g),
                                  cache_pos=pos, block_table=block_table,
                                  step=step)
    for t, lp in enumerate(p.tail):
        x, _ = _ssm_block_apply(lp, x, cfg, cache=_sub(caches["tail"], t))
    return x


def _state_caches(cfg: ArchConfig, batch: int, max_len: int, device,
                  ring: bool) -> Dict[str, object]:
    dtype = cfg.tdtype()
    one = _state_cache_init(cfg, batch, dtype, device)
    if cfg.family == "ssm":
        return _stacked(one, cfg.n_layers)
    groups, period, rem = _hybrid_layout(cfg)
    caches: Dict[str, object] = {}
    if groups:
        caches["groups"] = _stacked(one, groups, period)
        caches["attn"] = _stacked(attn.gqa_cache_init(
            cfg, batch, max_len, dtype, device,
            window=cfg.window if ring else None), groups)
    if rem:
        caches["tail"] = _stacked(one, rem)
    return caches


def _enc_block_apply(p: EncBlock, x, cfg: ArchConfig) -> torch.Tensor:
    # unmasked self-attention without RoPE is cross-attention of x over
    # its own K/V
    xn = _norm(p.ln1, x, cfg)
    x = x + attn.cross_attn_apply(p.attn, xn, attn.cross_kv(p.attn, xn, cfg),
                                  cfg)
    return x + ffn_mod.mlp_apply(p.mlp, _norm(p.ln2, x, cfg), cfg)


def _dec_block_apply(p: DecBlock, x, cfg: ArchConfig, enc_kv, *, positions,
                     cache=None, cache_pos=None, block_table=None,
                     return_kv=False, step=None):
    a, new_cache = attn.gqa_apply(p.attn, _norm(p.ln1, x, cfg), cfg,
                                  positions=positions, cache=cache,
                                  cache_pos=cache_pos,
                                  block_table=block_table,
                                  return_kv=return_kv, step=step)
    x = x + a
    x = x + attn.cross_attn_apply(p.cross, _norm(p.ln2, x, cfg), enc_kv, cfg)
    x = x + ffn_mod.mlp_apply(p.mlp, _norm(p.ln3, x, cfg), cfg)
    return x, new_cache


def _enc_step(lp: EncBlock, x, *, cfg: ArchConfig):
    return (_enc_block_apply(lp, x, cfg),)


def _encode(p: EncDecLM, cfg: ArchConfig, batch, remat: bool = False
            ) -> torch.Tensor:
    """The encoder stack over ``batch["enc_embeds"]``, then its final norm;
    under ``remat`` checkpointed as ``forward``'s other stacks."""
    x = batch["enc_embeds"].to(cfg.tdtype())
    fns = [functools.partial(_enc_step, lp, cfg=cfg) for lp in p.enc_layers]
    (x,) = _stack_forward(fns, (x,), cfg, remat=remat)
    return _norm(p.enc_lnf, x, cfg)


def _dec_step(lp: DecBlock, x, *, cfg: ArchConfig, enc_out, positions):
    ckv = attn.cross_kv(lp.cross, enc_out, cfg)
    return (_dec_block_apply(lp, x, cfg, ckv, positions=positions)[0],)


def _encdec_forward(p: EncDecLM, cfg: ArchConfig, x, positions, batch, *,
                    remat: bool) -> torch.Tensor:
    """``forward``'s pass over the encoder and decoder stacks (no caches)
    -> x before the final norm; each decoder block projects its cross K/V
    inside its own checkpoint, as the reference's scan body does."""
    enc_out = _encode(p, cfg, batch, remat=remat)
    fns = [functools.partial(_dec_step, lp, cfg=cfg, enc_out=enc_out,
                             positions=positions) for lp in p.layers]
    return _stack_forward(fns, (x,), cfg, remat=remat)[0]


def _encdec_stack(p: EncDecLM, cfg: ArchConfig, x, positions, batch):
    """The decoder over x [B, S, d], each block cross-attending over its
    projection of the encoded ``batch["enc_embeds"]`` -> (x before the
    final norm, the prefill caches {"self": {"k", "v"} [L, B, S, ...],
    "cross_k", "cross_v": [L, B, Se, ...]})."""
    enc_out = _encode(p, cfg, batch)
    kvs, cross = [], []
    for lp in p.layers:
        ckv = attn.cross_kv(lp.cross, enc_out, cfg)
        x, kv = _dec_block_apply(lp, x, cfg, ckv, positions=positions,
                                 return_kv=True)
        kvs.append(kv)
        cross.append(ckv)
    return x, {"self": {name: torch.stack([kv[name] for kv in kvs])
                        for name in kvs[0]},
               "cross_k": torch.stack([c[0] for c in cross]),
               "cross_v": torch.stack([c[1] for c in cross])}


def init_model(cfg: ArchConfig, seed: int = 0, device="cuda",
               store=None) -> LM:
    """Random weights from one ``torch.Generator`` seeded with ``seed`` on
    ``device`` (numbers differ from the reference's jax.random init; parity
    tests carry JAX weights over with ``repro_torch.convert``).  Under
    ``sparsity.mode == 'compressed'`` every linear is compressed as it is
    drawn, so the dense model never exists at once.  ``store``: where the
    model is kept, each block moved there as soon as it is drawn (the
    numbers drawn on ``device``: a tensor-parallel rank keeps the whole
    model on the host and moves only its shard to the card)."""
    _check_family(cfg)
    device = resolve_device(device)
    store = device if store is None else resolve_device(store)

    def kept(module):
        return module if store == device else module.to(store)
    # an abstract model (device "meta": shapes and dtypes, no storage,
    # for byte and parameter counts) draws without a generator
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dtype = cfg.tdtype()
    embed = kept(embed_init(gen, cfg.vocab, cfg.d_model, dtype, device))
    lnf = kept(rms_norm_init(cfg.d_model, device))
    if cfg.family == "ssm":
        return SSMLM(embed, [kept(_ssm_block_init(gen, cfg, dtype, device))
                             for _ in range(cfg.n_layers)], lnf)
    if cfg.family == "hybrid":
        groups, period, rem = _hybrid_layout(cfg)
        blocks = [[kept(_ssm_block_init(gen, cfg, dtype, device))
                   for _ in range(period)] for _ in range(groups)]
        shared = kept(_dense_block_init(gen, cfg, dtype, device)) \
            if groups else None
        tail = [kept(_ssm_block_init(gen, cfg, dtype, device))
                for _ in range(rem)]
        return HybridLM(embed, blocks, shared, tail, lnf)
    if cfg.family == "audio":
        enc = [kept(EncBlock(rms_norm_init(cfg.d_model, device),
                             attn.gqa_init(gen, cfg, dtype, device),
                             rms_norm_init(cfg.d_model, device),
                             ffn_mod.mlp_init(gen, cfg, dtype, device)))
               for _ in range(cfg.enc_layers)]
        enc_lnf = kept(rms_norm_init(cfg.d_model, device))
        dec = [kept(DecBlock(rms_norm_init(cfg.d_model, device),
                             attn.gqa_init(gen, cfg, dtype, device),
                             rms_norm_init(cfg.d_model, device),
                             attn.cross_attn_init(gen, cfg, dtype, device),
                             rms_norm_init(cfg.d_model, device),
                             ffn_mod.mlp_init(gen, cfg, dtype, device)))
               for _ in range(cfg.n_layers)]
        return EncDecLM(embed, enc, enc_lnf, dec, lnf)
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        dense = [kept(_dense_block_init(gen, cfg, dtype, device))
                 for _ in range(nd)]
        moe = [kept(_moe_block_init(gen, cfg, dtype, device))
               for _ in range(cfg.n_layers - nd)]
        return MoELM(embed, dense, moe, lnf)
    blocks = [kept(_dense_block_init(gen, cfg, dtype, device))
              for _ in range(cfg.n_layers)]
    return DenseLM(embed, blocks, lnf)


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device="cuda",
                ring: bool = True) -> Dict[str, torch.Tensor]:
    """Plain-layout decode caches, one leaf per name with the layer axis
    first: GQA {"k", "v"} [L, batch, max_len, kv, hd], MLA {"ckv", "kpe"}
    [L, batch, max_len, kv_lora | qk_rope_dim].  gemma2 (local / global
    pairs) gets {"local": {"k", "v"}, "global": {"k", "v"}}, each [L / 2,
    ...], the local layers a ring of ``min(max_len, window)`` positions,
    as the reference's; ``ring=False`` lifts the window: every layer gets
    ``max_len`` positions in one [L, ...] stack (the paged pool's layout and
    its staging's, where the window is a read mask).  The SSM and hybrid
    families get the reference's layouts (module docstring); the hybrid's
    "attn" caches are rings of the window, or ``max_len`` without
    ``ring``.  The audio family gets {"self": {"k", "v"} [L, batch,
    max_len, kv, hd], "cross_k", "cross_v": [L, batch, enc_seq, kv, hd]}."""
    _check_family(cfg)
    if cfg.family in STATE_FAMILIES:
        return _state_caches(cfg, batch, max_len, device, ring)
    dtype = cfg.tdtype()

    def stack(one, n):
        return {name: z.unsqueeze(0).repeat((n,) + (1,) * z.dim())
                for name, z in one.items()}

    if cfg.family == "audio":
        cross = torch.zeros((cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv,
                             cfg.hd()), dtype=dtype, device=device)
        return {"self": stack(attn.gqa_cache_init(cfg, batch, max_len, dtype,
                                                  device), cfg.n_layers),
                "cross_k": cross, "cross_v": cross.clone()}

    if cfg.local_global_period and ring:
        half = cfg.n_layers // 2
        return {"local": stack(attn.gqa_cache_init(
                    cfg, batch, max_len, dtype, device, window=cfg.window),
                    half),
                "global": stack(attn.gqa_cache_init(
                    cfg, batch, max_len, dtype, device), half)}
    init = attn.mla_cache_init if cfg.mla else attn.gqa_cache_init
    return stack(init(cfg, batch, max_len, dtype, device), cfg.n_layers)


def _layer_cache(caches, li: int) -> Dict[str, torch.Tensor]:
    """Cache layer ``li``'s leaves (views, written in place): slice ``li``
    of every [L, ...] leaf, or for gemma2's slotted pairs slice ``li // 2``
    of the local (even ``li``) or global (odd) leaves."""
    if "local" in caches:
        kind = caches["local" if li % 2 == 0 else "global"]
        return {name: leaf[li // 2] for name, leaf in kind.items()}
    return {name: leaf[li] for name, leaf in caches.items()}


def prefill(p: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            logit_pos: Union[int, torch.Tensor, None] = None):
    """Full-sequence forward over ``batch["tokens"]`` [B, S] (the vlm
    family: ``batch["embeds"]`` [B, S, d]; the audio family also encodes
    ``batch["enc_embeds"]`` [B, Se, d]) that returns
    the per-layer caches and only one position's logits [B, V] (f32): the
    last, or ``logit_pos`` (the bucketed-prefill hook for right-padded
    prompts): an int, or an integer tensor of one element on the model's
    device, read there (so one CUDA graph per bucket serves every
    position, as the reference lowers it to a traced int32 scalar).
    Caches are stacked [L, B, S, ...] leaves ({"k", "v"} or {"ckv",
    "kpe"}; gemma2's too, local and global layers in depth order, each at
    every position: ``seed_decode_caches`` cuts the local rings); the MoE
    family returns them per stack as the reference does, {"dense": ...,
    "moe": ...} ("dense" only with first_dense_layers).  The SSM family
    returns its final state {"h", "conv"} [L, B, ...], the hybrid
    {"groups": ..., "attn": {"k", "v"} [G, B, S, ...], "tail": ...}, the
    audio {"self": {"k", "v"} [L, B, S, ...], "cross_k", "cross_v" [L, B,
    Se, ...]}."""
    _check_family(cfg)
    x = _embed_in(p, cfg, batch)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)

    def run(blocks) -> Dict[str, torch.Tensor]:
        nonlocal x
        kvs = []
        for i, lp in enumerate(blocks):
            x, kv = _block_apply(lp, x, cfg, window=_window(cfg, i),
                                 positions=positions, return_kv=True)
            kvs.append(kv)
        return {name: torch.stack([kv[name] for kv in kvs])
                for name in kvs[0]}

    if isinstance(p, (SSMLM, HybridLM)):
        x, caches = _state_stack(p, cfg, x, positions)
    elif isinstance(p, EncDecLM):
        x, caches = _encdec_stack(p, cfg, x, positions, batch)
    elif isinstance(p, MoELM):
        caches = {"dense": run(p.dense_layers)} if len(p.dense_layers) else {}
        caches["moe"] = run(p.layers)
    else:
        caches = run(p.layers)
    x = _norm(p.lnf, x, cfg)
    if logit_pos is None:
        xl = x[:, -1:]
    elif isinstance(logit_pos, torch.Tensor):
        xl = x.index_select(1, logit_pos.reshape(1))
    else:
        xl = x[:, logit_pos:logit_pos + 1]
    logits = lm_head_apply(p.embed, xl, cfg.softcap_final)[:, 0]
    return logits, caches


def forward(p: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """Full-sequence forward over ``batch["tokens"]`` [B, S] (or the
    ``prefill`` inputs of the vlm and audio families), no caches ->
    (logits [B, S, V] f32, moe_aux): the MoE load-balance loss summed over
    the MoE blocks and divided by their count (0 for the other families),
    as the reference's."""
    _check_family(cfg)
    x = _embed_in(p, cfg, batch)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_moe = 0
    remat = cfg.remat and _records_grad(p)
    if isinstance(p, (SSMLM, HybridLM)):
        x = _state_forward(p, cfg, x, positions, remat=remat)
    elif isinstance(p, EncDecLM):
        x = _encdec_forward(p, cfg, x, positions, batch, remat=remat)
    else:
        blocks = p.blocks()
        fns = [functools.partial(_block_forward, lp, cfg=cfg,
                                 positions=positions, window=_window(cfg, i))
               for i, lp in enumerate(blocks)]
        x, aux = _stack_forward(fns, (x, aux), cfg, remat=remat)
        n_moe = sum(isinstance(lp, MoEBlock) for lp in blocks)
    x = _norm(p.lnf, x, cfg)
    return lm_head_apply(p.embed, x, cfg.softcap_final), aux / max(n_moe, 1)


def _records_grad(p: nn.Module) -> bool:
    """Whether a forward of ``p`` here records an autograd graph."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in p.parameters())


def _checkpoint(fn, *args):
    """An activation checkpoint of ``fn``, whose recompute runs under the
    mesh and rules its forward ran under (on the card the backward runs
    on autograd's own thread, which the thread's rules do not reach)."""
    from repro_torch.dist.api import axis_rules, current_mesh, current_rules
    mesh = current_mesh()
    if mesh is not None:
        rules, inner = current_rules(), fn

        def fn(*a):
            with axis_rules(mesh, rules):
                return inner(*a)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _block_forward(lp, x, aux, *, cfg: ArchConfig, positions, window):
    if isinstance(lp, MoEBlock):
        x, _, a = _moe_block_apply(lp, x, cfg, positions=positions)
        return x, aux + a
    x, _ = _dense_block_apply(lp, x, cfg, positions=positions, window=window)
    return x, aux


def _stack_forward(fns, carry: tuple, cfg: ArchConfig, *, remat: bool,
                   grouped: bool = True) -> tuple:
    """``forward``'s pass over a stack: each of ``fns`` maps the carry
    tuple (x, and the dense / MoE stack's aux sum) to the next.  Under
    ``remat`` every step is an activation checkpoint (its activations
    recomputed in the backward), and with ``grouped`` and
    ``cfg.remat_group`` G dividing the depth the G groups of L / G steps
    are checkpoints too, around their steps' own (the reference's
    sqrt-remat, ``_stacked_scan``)."""

    def run(lo: int, hi: int, *carry):
        for fn in fns[lo:hi]:
            carry = _checkpoint(fn, *carry) if remat else fn(*carry)
        return carry

    n, g = len(fns), cfg.remat_group
    if remat and grouped and g > 1 and n % g == 0:
        for j in range(g):
            carry = _checkpoint(functools.partial(run, j * n // g,
                                                  (j + 1) * n // g), *carry)
        return carry
    return run(0, n, *carry)


def loss_fn(p: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01):
    """Next-token loss over ``batch`` ({"tokens", "labels"} [B, S], with
    the vlm and audio families' inputs) ->
    (loss + aux_weight * moe_aux, {"loss", "moe_aux"})."""
    logits, aux = forward(p, cfg, batch)
    loss = cross_entropy(logits, batch["labels"])
    return loss + aux_weight * aux, {"loss": loss, "moe_aux": aux}


def decode_step(p: LM, cfg: ArchConfig, caches: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: torch.Tensor,
                block_table: Optional[torch.Tensor] = None,
                attn_impl: Optional[str] = None,
                layers: Optional[Sequence[int]] = None):
    """One token per slot: tokens [B] -> (logits [B, V] f32, caches).

    With ``block_table`` (int32 [B, max_blocks]) the caches are the paged
    pools ({"k", "v"} or {"ckv", "kpe"}, [L, n_blocks, block_size, ...])
    and ``pos`` is the int32 [B] per-slot position vector.  Without it they
    are the slotted caches of ``init_caches`` ([L, B, max_len, ...]) and
    ``pos`` is a 0-d tensor (the fixed batch: every row at one position)
    or the int32 [B] vector (the engine: each row at its own).

    The caches are updated **in place** (the returned ``caches`` is the
    argument).  ``attn_impl`` ('gather' | 'fused') overrides
    ``cfg.attn_impl`` for the paged read (slotted caches have one read).
    ``layers`` maps block i to cache layer ``layers[i]`` (a skip draft's
    ``cache_idx``); by default block i uses cache layer i.  The SSM and
    hybrid families update their state rows in place, whatever ``pos``;
    only the hybrid's shared attention reads ``pos`` and the table.  The
    audio family's decoder reads its slots' cross K/V rows and never
    writes them."""
    _check_family(cfg)
    logits = _cached_forward(p, cfg, caches, tokens[:, None], pos,
                             block_table, attn_impl, layers)
    return logits[:, 0], caches


def verify_step(p: LM, cfg: ArchConfig, caches: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: torch.Tensor,
                block_table: Optional[torch.Tensor] = None,
                attn_impl: Optional[str] = None):
    """Speculative verify: score a span of S tokens per slot in one forward.

    tokens [B, S] occupy positions ``pos .. pos + S - 1`` (pos the int32
    [B] per-slot vector) -> (logits [B, S, V] f32, caches).  Row r's logits
    at offset i are the next-token distribution after ``tokens[r, :i + 1]``,
    what S sequential ``decode_step`` calls would give: the span's K/V are
    written first (in place) and query offset i reads positions <= pos + i
    only.  Needs the paged pool (``block_table``) and a family whose
    decode state does not move with the span: a recurrent state cannot
    score a span and roll back, so the SSM and hybrid families raise
    ``ValueError``; the audio family's cross K/V are only read, and it
    verifies as the reference's does."""
    _check_family(cfg)
    if cfg.family in STATE_FAMILIES:
        raise ValueError(f"verify_step needs every cache leaf behind the "
                         f"block table; {cfg.family!r} keeps slot-indexed "
                         f"recurrent state")
    if block_table is None:
        raise ValueError("verify_step requires a block_table (the span "
                         "write/read is paged-only)")
    logits = _cached_forward(p, cfg, caches, tokens, pos, block_table,
                             attn_impl)
    return logits, caches


def _cached_forward(p: LM, cfg: ArchConfig, caches, tokens, pos, block_table,
                    attn_impl, layers=None):
    """Every block over tokens [B, S] at positions ``pos`` against the
    decode caches (updated in place; block i on cache layer ``layers[i]``,
    or i) -> f32 logits [B, S, V].  Over the paged pools the RoPE angles,
    kv_len and the span write's cells are computed once here
    (``attn.paged_step``) and shared by every block."""
    if attn_impl is not None and attn_impl != cfg.attn_impl:
        cfg = cfg.replace(attn_impl=attn_impl)
    x = _embed(p, cfg, tokens)
    if isinstance(p, (SSMLM, HybridLM)):
        x = _state_cached(p, cfg, caches, x, pos, block_table, layers)
        return lm_head_apply(p.embed, _norm(p.lnf, x, cfg),
                             cfg.softcap_final)
    encdec = isinstance(p, EncDecLM)
    kv = caches["self"] if encdec else caches
    step = None if block_table is None else attn.paged_step(
        cfg, pos, tokens.shape[1], block_table,
        next(iter(kv.values())).shape[2])
    for i, lp in enumerate(p.blocks()):
        li = i if layers is None else int(layers[i])
        kw = dict(positions=pos, cache=_layer_cache(kv, li), cache_pos=pos,
                  block_table=block_table, step=step)
        if encdec:
            x, _ = _dec_block_apply(lp, x, cfg, (caches["cross_k"][li],
                                                 caches["cross_v"][li]), **kw)
        else:
            x, _ = _block_apply(lp, x, cfg, window=_window(cfg, i), **kw)
    x = _norm(p.lnf, x, cfg)
    return lm_head_apply(p.embed, x, cfg.softcap_final)


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


def convert_to_compressed(p: LM, cfg: ArchConfig) -> LM:
    """Model-wide offline packing pass: every SparseLinear (expert stacks
    included) the sparsity policy applies to moves to the compressed N:M
    serving format; the MoE router (an f32 parameter, not a linear), norms and
    the embedding are shared with ``p``, which is left unchanged."""
    sp = cfg.sparsity
    return _map_linears(p, lambda q: sparse_layers.convert_to_compressed(q, sp))


def make_draft(p: LM, cfg: ArchConfig, kind: str = "rerank",
               stride: int = 2):
    """A cheaper *draft view* of the served model for self-speculative
    decoding -> ``(draft, draft_cfg, cache_idx)``.

    ``kind="rerank"``: every compressed n:m linear (expert stacks included)
    is re-ranked to 1:m by ``nm_rerank`` on its stored operands, and
    ``draft_cfg`` has ``n=1``; the draft streams 1/n of the linears' bytes
    through the same decode kernels.  Embedding, norms, router and
    uncompressed leaves are the target's own tensors.  ``cache_idx`` is
    None: the draft has every layer.  Needs a compressed model (n > 1).

    ``kind="skip"``: keeps every ``stride``-th block of a plain stacked
    ``layers`` family (dense, MoE, SSM; the ``first_dense_layers`` always);
    its blocks are the target's own modules.  ``cache_idx`` (int32) names
    the target cache layers the draft's layers read and write.  gemma2's
    pairs, the hybrid's groups and the enc-dec stacks raise
    ``ValueError``, as in the reference.

    Neither view copies a shared tensor."""
    if kind == "rerank":
        sp = cfg.sparsity
        if sp.mode != "compressed" or sp.n <= 1:
            raise ValueError(
                f"rerank draft needs a converted compressed model with "
                f"n > 1, got mode={sp.mode!r} n={sp.n} (run "
                f"convert_to_compressed first)")

        def rerank(lin: SparseLinear) -> SparseLinear:
            if not lin.compressed:
                return lin
            v, i = nm_rerank(lin.w_vals, lin.w_idx, sp.n, sp.m, 1)
            return type(lin)(w_vals=v, w_idx=i,
                             b=lin.b if lin.has("b") else None)

        dcfg = cfg.replace(sparsity=dataclasses.replace(sp, n=1))
        return _map_linears(p, rerank), dcfg, None
    if kind == "skip":
        if isinstance(p, (HybridLM, EncDecLM)) or cfg.local_global_period:
            raise ValueError(
                f"skip draft needs a plain stacked 'layers' family "
                f"(dense/MoE); {cfg.family!r} does not qualify")
        if stride < 2:
            raise ValueError(f"need stride >= 2, got {stride}")
        nd = cfg.first_dense_layers
        midx = list(range(0, cfg.n_layers - nd, stride))
        draft = copy.copy(p)
        draft._modules = dict(p._modules)
        draft._modules["layers"] = nn.ModuleList([p.layers[i] for i in midx])
        cache_idx = np.asarray(list(range(nd)) + [nd + i for i in midx],
                               np.int32)
        return draft, cfg.replace(n_layers=nd + len(midx)), cache_idx
    raise ValueError(f"draft kind must be 'rerank' or 'skip', got {kind!r}")


def weight_stream_bytes(p: LM, cfg: ArchConfig) -> Dict[str, float]:
    """Decode weight-stream accounting, per rank (a model cut by
    ``shard_model`` counts the shards this rank holds): every decode step
    reads each linear once, so per-step traffic is the sum of their
    stored bytes — values
    plus packed ceil(log2 M)-bit indices for converted leaves, the dense
    weight otherwise (embedding, norms and the MoE router excluded on both
    sides).  An expert stack counts as one linear of E x its bytes, and
    the hybrid's shared block once (as the reference walks its params;
    a decode tick reads it once per application); the audio family's
    encoder and cross-attention ``wk`` / ``wv`` count too, as the
    reference's walk counts them, though a decode tick reads neither.  The ``*_linears``
    counts are per layer (the reference counts a stacked [L, ...] leaf
    once)."""
    tot = {"dense_bytes": 0, "stream_bytes": 0,
           "compressed_linears": 0, "dense_linears": 0}
    for lin in _linears(p):
        d, s = linear_weight_bytes(lin, cfg.sparsity)
        tot["dense_bytes"] += d
        tot["stream_bytes"] += s
        tot["compressed_linears" if lin.compressed else "dense_linears"] += 1
    tot["ratio"] = tot["stream_bytes"] / max(tot["dense_bytes"], 1)
    return tot


# --------------------------------------------------- tensor-parallel serving

# Leaf names that carry a linear's [..., out, in]-shaped tensors (or the
# compressed [..., out, nnz] pair), and the MoE router [E, d] (the
# reference's ``router.w``).  The walk is structural, keyed on these names,
# so it covers the tree after ``convert_to_compressed`` as well as before.
_LINEAR_LEAF_KEYS = frozenset({"w", "w_vals", "w_idx", "mask", "router"})
# the leaves whose rows a linear-like module's ``tp_rows`` records
_ROW_KEYS = ("w", "w_vals", "emb", "router")


def param_shard_specs(p: nn.Module) -> Dict[str, Optional[tuple]]:
    """Logical shard specs of a (possibly compressed) serving model,
    {parameter or buffer name: spec}, None for replicated.  Output-feature
    axes get "tp" (axis -2 of every linear-like leaf, -1 of biases, 0 of
    the embedding table); contraction axes and stack axes (experts) stay
    whole, so TP decode keeps the one-device reduction order.  The
    reference's spec of the same leaf (``convert.reference_path``) is this
    one behind the stacked layer axes."""
    out: Dict[str, Optional[tuple]] = {}
    for name, t in list(p.named_parameters()) + list(p.named_buffers()):
        leaf, nd = name.rsplit(".", 1)[-1], t.dim()
        if leaf == "emb" and nd == 2:
            out[name] = ("tp", None)
        elif leaf in _LINEAR_LEAF_KEYS and nd >= 2:
            out[name] = (None,) * (nd - 2) + ("tp", None)
        elif leaf == "b" and nd >= 1:
            out[name] = (None,) * (nd - 1) + ("tp",)
        else:
            out[name] = None
    return out


def shard_model(p: LM, mesh, rules=None, device=None) -> LM:
    """A copy of ``p`` holding this rank's shard of every leaf that
    ``param_shard_specs`` and ``rules`` (default ``SERVE_TP_RULES``) split
    over ``mesh``; ``p`` is left whole.  A module whose rows were split
    records their whole count: ``tp_rows`` on a linear (weights and bias)
    or the embedding, ``tp_router`` on an MoE layer.  ``device``: where the
    copy's leaves live (default: where ``p``'s do); ``p`` is not moved, so
    a whole model kept on the host puts only the shard on the card.  Run
    after ``convert_to_compressed``, as the reference shards after
    conversion."""
    from repro_torch.dist.api import SERVE_TP_RULES, Sharding, logical_to_pspec
    rules = SERVE_TP_RULES if rules is None else rules
    specs = param_shard_specs(p)

    def cut(module: nn.Module, prefix: str) -> nn.Module:
        new = copy.copy(module)
        new._modules = {name: cut(child, f"{prefix}{name}.")
                        for name, child in module._modules.items()}
        new._parameters = dict(module._parameters)
        new._buffers = dict(module._buffers)
        for store in (new._parameters, new._buffers):
            for name, t in store.items():
                if t is None:
                    continue
                spec = specs.get(prefix + name)
                sh = None if spec is None else Sharding(logical_to_pspec(
                    spec, rules, mesh=mesh, shape=tuple(t.shape)), mesh)
                if sh is None or not sh.spec:
                    if device is not None and t.device != device:
                        store[name] = _moved(t, device)
                    continue
                local = sh(t.detach())
                if device is not None:
                    local = local.to(device)
                store[name] = (nn.Parameter(local, requires_grad=False)
                               if isinstance(t, nn.Parameter) else local)
                if name in _ROW_KEYS:
                    rows = t.shape[0] if name == "emb" else t.shape[-2]
                    setattr(new, "tp_router" if name == "router"
                            else "tp_rows", rows)
        return new

    return cut(p, "")


def train_shard_specs(p: nn.Module) -> Dict[str, Optional[tuple]]:
    """Logical training specs of a model, {parameter or buffer name:
    spec}.  Output-feature axes get "tp" (the row layout of serving: an
    N:M block never straddles a shard), the contraction axis "fsdp"
    (embedding: its d axis), an expert stack's expert axis "ep", the MoE
    router (None, "fsdp") as the reference's; a bias is ("tp",) and any
    other leaf (norm scales, the mixers' tensors) "fsdp" on its first
    axis.  The reference splits the contraction of ``wo`` / ``wd`` over
    "tp" instead (ROADMAP C); every other linear's spec is the
    reference's."""
    stacks = {name for name, m in p.named_modules()
              if isinstance(m, sparse_layers.StackedLinear)}
    out: Dict[str, Optional[tuple]] = {}
    for name, t in list(p.named_parameters()) + list(p.named_buffers()):
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        nd = t.dim()
        if owner in stacks and leaf in _LINEAR_LEAF_KEYS and nd == 3:
            out[name] = ("ep", "tp", "fsdp")
        elif leaf == "emb" and nd == 2:
            out[name] = ("tp", "fsdp")
        elif leaf == "router" and nd == 2:
            out[name] = (None, "fsdp")
        elif leaf in _LINEAR_LEAF_KEYS and nd >= 2:
            out[name] = (None,) * (nd - 2) + ("tp", "fsdp")
        elif leaf == "b" and nd >= 1:
            out[name] = (None,) * (nd - 1) + ("tp",)
        elif nd >= 1:
            out[name] = ("fsdp",) + (None,) * (nd - 1)
        else:
            out[name] = None
    return out


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """How one leaf lies on a training mesh: ``spec`` its resolved entries
    (``dist.api.Sharding``); ``dim`` the dimension its data-side split
    (FSDP / EP) cuts, over the axes ``split`` (None / (): whole over
    them); ``rest`` the batch axes it is replicated on, over which its
    gradient is all-reduced; ``rep`` how many ranks hold each of its
    elements (the gradient norm counts each once)."""
    spec: tuple
    dim: Optional[int]
    split: tuple
    rest: tuple
    rep: int


def _layout(spec: tuple, mesh, batch: Sequence[str]) -> LeafLayout:
    dim, split, used = None, (), set()
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        used.update(names)
        if "model" not in names:
            dim, split = i, names
    rest = tuple(a for a in batch if a not in used)
    rep = int(np.prod([n for a, n in mesh.shape.items() if a not in used]))
    return LeafLayout(spec, dim, split, rest, rep)


def _model_only(spec: tuple) -> tuple:
    return tuple(e if e is not None and "model" in (
        e if isinstance(e, tuple) else (e,)) else None for e in spec)


def shard_for_training(p: LM, mesh, rules=None, serve: bool = False):
    """(skeleton, {parameter or buffer name: LeafLayout}) of ``p`` on a
    training mesh under ``rules`` (default: the active ones).  The
    skeleton is a copy of ``p`` whose parameters are this rank's shards over every axis
    (the leaves the trainer updates: the memory the mesh saves) and whose
    buffers are cut over "model" only (with ``serve``, over every axis as
    the parameters: a compressed serving model's ``w_vals`` / ``w_idx``
    are its weights, ``launch.steps``' serving steps gather them); a
    linear whose rows "model" splits
    records their whole count (``tp_rows``), as ``shard_model`` does.  It
    is never called as it is: ``bind_params`` puts the gathered leaves in
    place for a forward.  ``p`` is left whole."""
    from repro_torch.dist.api import (Sharding, batch_axes, current_rules,
                                      logical_to_pspec)
    rules = current_rules() if rules is None else rules
    specs = train_shard_specs(p)
    batch = batch_axes()
    layouts: Dict[str, LeafLayout] = {}
    names = {id(t): name for name, t in p.named_parameters()}
    names.update({id(t): name for name, t in p.named_buffers()})
    memo: Dict[int, torch.Tensor] = {}

    def cut(module: nn.Module, prefix: str) -> nn.Module:
        new = copy.copy(module)
        new._modules = {name: cut(child, f"{prefix}{name}.")
                        for name, child in module._modules.items()}
        new._parameters = dict(module._parameters)
        new._buffers = dict(module._buffers)
        for store in (new._parameters, new._buffers):
            for name, t in store.items():
                if t is None:
                    continue
                if id(t) in memo:
                    store[name] = memo[id(t)]
                    continue
                spec = specs.get(prefix + name)
                pspec = () if spec is None else logical_to_pspec(
                    spec, rules, mesh=mesh, shape=tuple(t.shape))
                if isinstance(t, nn.Parameter):
                    layouts[names[id(t)]] = _layout(pspec, mesh, batch)
                    local = nn.Parameter(Sharding(pspec, mesh)(t.detach()),
                                         requires_grad=False)
                elif serve:
                    layouts[names[id(t)]] = _layout(pspec, mesh, batch)
                    local = Sharding(pspec, mesh)(t)
                else:
                    layouts[names[id(t)]] = _layout(_model_only(pspec),
                                                    mesh, batch)
                    local = Sharding(_model_only(pspec), mesh)(t)
                memo[id(t)] = store[name] = local
                model_dims = [d for d, names in Sharding(pspec, mesh).axes()
                              if "model" in names]
                if name in _ROW_KEYS and model_dims:
                    if model_dims != [0 if name == "emb" else t.dim() - 2]:
                        raise ValueError(f"{prefix}{name}: 'model' splits "
                                         f"dims {model_dims}, not its rows")
                    rows = t.shape[0] if name == "emb" else t.shape[-2]
                    setattr(new, "tp_router" if name == "router"
                            else "tp_rows", rows)
        return new

    return cut(p, ""), layouts


def bind_params(skeleton: nn.Module, leaves: Dict[str, torch.Tensor]
                ) -> nn.Module:
    """A shallow copy of ``skeleton`` whose parameters are ``leaves``
    ({parameter name: tensor}, as ``named_parameters`` names them; a
    parameter shared by two modules is replaced in both), for a forward
    and its backward: activation checkpoints recompute from these same
    tensors."""
    by_id = {id(t): leaves[name] for name, t in skeleton.named_parameters()}

    def walk(module: nn.Module) -> nn.Module:
        new = copy.copy(module)
        new._modules = {k: walk(m) for k, m in module._modules.items()}
        new._parameters = {k: (by_id[id(t)] if t is not None else None)
                           for k, t in module._parameters.items()}
        return new

    return walk(skeleton)


def gather_leaf(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """A leaf's whole tensor from this rank's shard ``t`` under the
    resolved ``spec``, every rank getting it (no autograd)."""
    from repro_torch.dist.api import Sharding
    from repro_torch.dist.collectives import gather_dim
    for dim, names in Sharding(spec, mesh).axes():
        t = gather_dim(t, mesh.axis(*names), dim, key="gather_bytes")
    return t


def gather_model(skeleton: nn.Module, layouts: Dict[str, LeafLayout],
                 mesh) -> nn.Module:
    """The whole model from a training skeleton's shards: every leaf
    gathered over every axis of the mesh, on every rank, its ``tp_rows``
    / ``tp_router`` marks dropped: the model an unsharded run would hold,
    for saving and serving."""
    names = {id(t): n for n, t in skeleton.named_parameters()}
    names.update({id(t): n for n, t in skeleton.named_buffers()})
    memo: Dict[int, torch.Tensor] = {}

    def whole(t: torch.Tensor) -> torch.Tensor:
        if id(t) not in memo:
            full = gather_leaf(t.detach(), layouts[names[id(t)]].spec, mesh)
            memo[id(t)] = (nn.Parameter(full, requires_grad=False)
                           if isinstance(t, nn.Parameter) else full)
        return memo[id(t)]

    def walk(module: nn.Module) -> nn.Module:
        new = copy.copy(module)
        new.__dict__ = dict(module.__dict__)
        new.__dict__.pop("tp_rows", None)
        new.__dict__.pop("tp_router", None)
        new._modules = {k: walk(m) for k, m in module._modules.items()}
        new._parameters = {k: None if t is None else whole(t)
                           for k, t in module._parameters.items()}
        new._buffers = {k: None if t is None else whole(t)
                        for k, t in module._buffers.items()}
        return new

    return walk(skeleton)


def _moved(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` copied to ``device``, a parameter as a parameter."""
    out = t.detach().to(device)
    return (nn.Parameter(out, requires_grad=t.requires_grad)
            if isinstance(t, nn.Parameter) else out)


def serve_ring_traffic_bytes(p: LM, cfg: ArchConfig, ndev: int
                             ) -> Dict[str, float]:
    """Modeled interconnect bytes of one decode step at TP = ``ndev``, over
    the whole (unsharded) model: each step streams every linear once; under
    the sparse ring a converted linear's *compressed* shard rotates
    (``ring_bytes``), against the same ring shipping dense weights
    (``dense_ring_bytes``).  A linear whose rows do not divide over the
    mesh runs locally and adds nothing (``local_linears``).  Bytes equal
    the reference's; the linear counts are per layer (an expert stack is
    one), as in ``weight_stream_bytes``."""
    from repro_torch.dist.collectives import ring_matmul_bytes
    sp = cfg.sparsity
    tot = {"ring_bytes": 0, "dense_ring_bytes": 0,
           "ring_linears": 0, "local_linears": 0}
    for lin in _linears(p):
        leaf = lin.w_vals if lin.compressed else lin.w
        stack = int(np.prod(leaf.shape[:-2], dtype=np.int64)) \
            if leaf.dim() > 2 else 1
        o = leaf.shape[-2]
        db = leaf.element_size()
        if ndev <= 1 or o % ndev:
            tot["local_linears"] += 1
            continue
        tot["ring_linears"] += 1
        if lin.compressed:
            k = leaf.shape[-1] * sp.m // sp.n
            tot["ring_bytes"] += stack * ring_matmul_bytes(
                o, k, ndev, sp.n, sp.m, dtype_bytes=db, sparse=True)
        else:
            k = leaf.shape[-1]
            tot["ring_bytes"] += stack * ring_matmul_bytes(
                o, k, ndev, dtype_bytes=db, sparse=False)
        tot["dense_ring_bytes"] += stack * ring_matmul_bytes(
            o, k, ndev, dtype_bytes=db, sparse=False)
    tot["ratio"] = tot["ring_bytes"] / max(tot["dense_ring_bytes"], 1)
    return tot


def _decode_linears(p: LM) -> List[SparseLinear]:
    """The linears one decode tick multiplies through ``linear_apply``,
    once per application: the hybrid's shared block once per group; not
    the audio family's encoder or cross-attention ``wk`` / ``wv`` (its
    cross K/V are cached), MLA's absorbed ``wuk`` / ``wuv`` (decompressed
    into the query and the context) or an expert stack (one batched
    product of its dense view)."""
    if isinstance(p, HybridLM):
        mods = ([lp for group in p.groups for lp in group]
                + [p.shared] * len(p.groups) + list(p.tail))
    elif isinstance(p, SSMLM):
        mods = list(p.layers)
    else:
        mods = p.blocks()
    skip = set()
    for m in mods:
        if isinstance(m, DecBlock):
            skip |= {id(m.cross.wk), id(m.cross.wv)}
        if isinstance(getattr(m, "attn", None), attn.MLA):
            skip |= {id(m.attn.wuk), id(m.attn.wuv)}
    return [lin for m in mods for lin in _linears(m)
            if id(lin) not in skip
            and not isinstance(lin, sparse_layers.StackedLinear)]


def decode_ring_bytes(p: LM, cfg: ArchConfig, ndev: int) -> int:
    """Bytes the compressed ring sends over every rank in one decode tick
    at TP = ``ndev``, of the whole (unsharded) model: each compressed
    linear the tick runs (``_decode_linears``) whose rows divide over the
    mesh, once per application.  ``serve_ring_traffic_bytes`` counts each
    stored linear once instead, as the reference's model does."""
    from repro_torch.dist.collectives import ring_matmul_bytes
    if ndev <= 1:
        return 0
    sp = cfg.sparsity
    return sum(ring_matmul_bytes(lin.w_vals.shape[-2],
                                 lin.w_vals.shape[-1] * sp.m // sp.n, ndev,
                                 sp.n, sp.m,
                                 dtype_bytes=lin.w_vals.element_size())
               for lin in _decode_linears(p)
               if lin.compressed and lin.w_vals.shape[-2] % ndev == 0)


# a cache leaf's logical spec behind its stacked layer axes (the paged
# pool's block axes take the batch / sequence names, which the serving
# rules leave whole)
_CACHE_SPECS = {
    "k": ("act_batch", "act_seq_sp", "act_heads", None),
    "v": ("act_batch", "act_seq_sp", "act_heads", None),
    "ckv": ("act_batch", "act_seq_sp", None),
    "kpe": ("act_batch", "act_seq_sp", None),
    "cross_k": ("act_batch", None, "act_heads", None),
    "cross_v": ("act_batch", None, "act_heads", None),
    "conv": ("act_batch", None, "act_heads"),
}


def cache_specs(caches, stack: int = 1) -> Dict:
    """Logical shard specs of any family's decode caches (the tree of
    ``init_caches`` or of the paged pool), the reference's: GQA's and the
    hybrid's {"k", "v"} [L, batch, seq, kv, hd] and the audio family's
    cross K/V [L, batch, Se, kv, hd] split their kv-head axis
    ("act_heads"); MLA's latent {"ckv", "kpe"} have no head axis and
    replicate; the SSM state ``h`` splits its channel (Mamba1, [L, batch,
    d_inner, state]) or head (Mamba2, [L, batch, nh, hd, state]) axis and
    the conv tail [L, batch, K - 1, d_inner] its channels.  The hybrid's
    "groups" stack two layer axes.  A leaf of another name or rank
    raises."""
    def one(name, t):
        if name == "h":
            body = ("act_batch", "act_heads") + (None,) * (t.dim() - stack - 2)
        else:
            body = _CACHE_SPECS.get(name)
        if body is None or stack + len(body) != t.dim():
            raise ValueError(f"no tensor-parallel layout for cache leaf "
                             f"{name!r} {tuple(t.shape)}")
        return (None,) * stack + body

    return {name: (cache_specs(t, 2 if name == "groups" else stack)
                   if isinstance(t, dict) else one(name, t))
            for name, t in caches.items()}
