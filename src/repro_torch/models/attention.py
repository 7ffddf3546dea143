"""GQA, MLA and cross-attention and their paged KV caches (counterpart of
``repro.models.attention``).

Prefill runs ``chunked_attention``, a plain-torch online-softmax attention
over (q_chunk, kv_chunk) tiles.  Decode is one token per slot against the
paged block pool, read either by a fused kernel (``cfg.attn_impl ==
"fused"``: ``paged_gqa_decode`` / ``paged_mla_decode``) or by gathering each
slot's blocks back into position order first (``"gather"``, the oracle).
A span of S > 1 tokens per slot (the speculative verify step) writes all S
positions, then scores offset i against the ``pos + i + 1`` positions up to
its own (``paged_gqa_verify`` / ``paged_mla_verify``, or the gather read
with a per-offset causal mask).

GQA: query head ``h`` uses kv head ``h // G`` (G = n_heads // n_kv) in
prefill and decode alike.  MLA caches the latent ``ckv`` [kv_lora] and the
roped ``kpe`` [qk_rope_dim] per token; prefill up-projects them to per-head
K/V, decode runs absorbed in the latent space (``wuk`` folded into the
query, ``wuv`` applied to the latent context).  Decode writes the new
token's cache entries into the pool **in place** (``_paged_write_span``);
the reference returned a new pool instead.

Without a block table, decode runs against the slotted caches (one row per
slot, [B, max_len, ...] per layer; the fixed-batch oracle and
``ServeEngine(kv="slotted")``): one token per row written in place at its
position (``_ring_write``: GQA's cache is a ring of its length, whose slot
j holds position ``pos - ((pos - j) mod L)``), then the gather read's
score chain over the whole row.  The position is a 0-d tensor (every row
at one position) or a per-row [B] vector.

Tensor-parallel serving (a serving mesh active and the heads split by
the rules: GQA's kv heads, MLA's heads, each dividing the mesh): each rank
projects and attends with its own heads (``linear_apply(local=True)``)
over its own shard of the pool's head axis, then all-gathers the heads
before the output projection.  MLA's latent ``ckv`` / ``kpe`` have no
head axis and stay whole on every rank; its absorbed ``wuk`` / ``wuv``
are decompressed for the local heads only.  Heads the mesh does not
divide are computed whole on every rank.  Training over the "model" axis
runs the same layout; the shared rope key ``kpe``, which meets only the
rank's heads, passes ``reduce_grad``.

Cross-attention (the audio family's decoder, and its encoder's unmasked
self-attention) projects its queries and reads the encoder's K/V [B, Se,
kv, hd] through ``chunked_attention`` without a mask, plain torch as in
the reference; ``cross_kv`` projects the encoder output once per request.
Under a mesh both are head-local as GQA is, and the slots' cross K/V
rows hold the rank's kv heads.  The decode caches keep those K/V
one row per slot (slot-indexed state beside the paged self-attention
pool), and decode reads them, never writes them.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.layers import (SparseLinear, dense_view, linear_apply,
                                     linear_init, whole_rows)
from repro_torch.dist.api import local_part, require_mesh
from repro_torch.dist.collectives import (all_gather, all_gather_last,
                                          reduce_grad)
from repro_torch.kernels.flash_attention import (paged_gqa_decode,
                                                 paged_gqa_verify,
                                                 paged_mla_decode,
                                                 paged_mla_verify)
from repro_torch.models.common import apply_rope, rope_angles, softcap
from repro_torch.models.config import ArchConfig

_NEG = -1e30


def _pick_chunk(s: int, want: int) -> int:
    """The reference's chunk, the largest divisor of ``s`` up to ``want``;
    where that is under half of ``min(want, s)`` (a length with no good
    divisor: 4168 = 8 x 521 would run 521 x 521 chunk pairs through
    ``chunked_attention``'s loop), ``min(want, s)``, the tail padded."""
    c = d = min(want, s)
    while s % d:
        d -= 1
    return d if 2 * d >= c else c


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      cap: Optional[float] = None,
                      scale: Optional[float] = None, q_chunk: int = 512,
                      kv_chunk: int = 1024,
                      chain_bf16: bool = False) -> torch.Tensor:
    """Online-softmax attention in f32.

    q [B, Sq, H, Dq], k [B, Sk, KVH, Dq], v [B, Sk, KVH, Dv]; H % KVH == 0
    and query head h reads kv head h // (H // KVH).  Returns [B, Sq, H, Dv]
    in v.dtype.  The q tokens occupy positions Sk - Sq ... Sk - 1.  A
    (q chunk, kv chunk) pair that the causal mask or the window masks
    everywhere is skipped: it would add p = 0 under a correction of exactly
    1, so skipping it changes no bit.  ``chain_bf16`` rounds each [cq, ck]
    score and probability tile to bf16, as the reference's; the running
    max, the sum and the output accumulate in f32 either way.
    """
    b, sq, h, dq = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    scale = scale if scale is not None else dq ** -0.5
    cq, ck = _pick_chunk(sq, q_chunk), _pick_chunk(sk, kv_chunk)
    nq, nk = -(-sq // cq), -(-sk // ck)
    q_off = sk - sq
    dev = q.device
    # under autograd each kv step is a checkpoint, as the reference's: its
    # [cq, ck] scores and probabilities are recomputed in the backward,
    # not kept for every chunk pair
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * cq - sq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * ck - sk))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * ck - sk))
    qg = q.reshape(b, nq, cq, kvh, g, dq).permute(1, 0, 3, 4, 2, 5).float()
    kc = k.reshape(b, nk, ck, kvh, dq).permute(1, 0, 3, 2, 4).float()
    vc = v.reshape(b, nk, ck, kvh, dv).permute(1, 0, 3, 2, 4).float()
    outs = []
    for qi in range(nq):
        q_lo = q_off + qi * cq
        qpos = q_lo + torch.arange(cq, device=dev)
        m = torch.full((b, kvh, g, cq), _NEG, device=dev)
        l = torch.zeros((b, kvh, g, cq), device=dev)
        acc = torch.zeros((b, kvh, g, cq, dv), device=dev)
        for ki in range(nk):
            if causal and ki * ck > q_lo + cq - 1:
                continue
            if window is not None and q_lo - (ki * ck + ck - 1) >= window:
                continue
            kpos = ki * ck + torch.arange(ck, device=dev)
            mask = (kpos < sk)[None, :].expand(cq, ck)
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window is not None:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            step = functools.partial(_kv_step, mask=mask, scale=scale,
                                     cap=cap, chain_bf16=chain_bf16)
            args = (m, l, acc, qg[qi], kc[ki], vc[ki])
            m, l, acc = (torch.utils.checkpoint.checkpoint(
                step, *args, use_reentrant=False, preserve_rng_state=False)
                if remat else step(*args))
        outs.append(acc / l.clamp_min(1e-30)[..., None])   # [b, kvh, g, cq, dv]
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, nq * cq, h,
                                                              dv)
    return out[:, :sq].to(v.dtype)


def _kv_step(m, l, acc, qc, kc, vc, *, mask, scale, cap, chain_bf16=False):
    """One kv chunk of the online softmax: (m, l, acc) of a q chunk ->
    the same after the chunk's keys."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
    s = softcap(s, cap)
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    if chain_bf16:
        s = s.to(torch.bfloat16).float()
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(mask, torch.exp(s - m_new[..., None]),
                    torch.zeros_like(s))
    if chain_bf16:
        p = p.to(torch.bfloat16).float()
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
    return m_new, l, acc


# ------------------------------------------------------------------------ GQA

class GQA(nn.Module):
    def __init__(self, wq: SparseLinear, wk: SparseLinear, wv: SparseLinear,
                 wo: SparseLinear):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def gqa_init(gen: torch.Generator, cfg: ArchConfig, dtype,
             device="cuda") -> GQA:
    d, hd, h, kv = cfg.d_model, cfg.hd(), cfg.n_heads, cfg.n_kv
    sp = cfg.sparsity
    return GQA(linear_init(gen, d, h * hd, sp, dtype, device, cfg.qkv_bias),
               linear_init(gen, d, kv * hd, sp, dtype, device, cfg.qkv_bias),
               linear_init(gen, d, kv * hd, sp, dtype, device, cfg.qkv_bias),
               linear_init(gen, h * hd, d, sp, dtype, device))


def gqa_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device="cuda", window: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """Plain KV cache leaves [batch, length, kv, hd]: ``length`` is
    ``max_len``, or for a windowed layer a ring of ``min(max_len,
    window)`` positions (``_ring_write`` / ``_ring_valid``)."""
    length = min(max_len, window) if window else max_len
    z = torch.zeros((batch, length, cfg.n_kv, cfg.hd()), dtype=dtype,
                    device=device)
    return {"k": z, "v": z.clone()}


class PagedStep(NamedTuple):
    """What every block of one paged forward shares, computed once per
    forward (``paged_step``): the RoPE angles of the span's positions, the
    per-slot kv_len and the span write's cells (``_span_cells``)."""
    cos: torch.Tensor
    sin: torch.Tensor
    kv_len: torch.Tensor
    cells: Tuple[torch.Tensor, torch.Tensor]


def paged_step(cfg: ArchConfig, cache_pos: torch.Tensor, s: int,
               block_table: torch.Tensor, block_size: int) -> PagedStep:
    """The per-forward invariants of S tokens per slot at positions
    ``cache_pos .. cache_pos + S - 1``: the same tensors every block would
    compute for itself, so a forward that hoists them is bit-equal."""
    cos, sin = _rope(cache_pos, s, cfg.qk_rope_dim if cfg.mla else cfg.hd(),
                     cfg)
    return PagedStep(cos, sin, _paged_kv_len(cache_pos),
                     _span_cells(block_table, cache_pos, s, block_size))


def _span_cells(block_table, cache_pos, span: int, bsz: int):
    """(cell, last) of a span write: row r's offset i (flattened r * S + i)
    lands in pool cell ``cell`` (block * block_size + offset), and
    ``last`` names, for each write, the flattened write whose value the
    cell takes (see ``_paged_write_span``)."""
    posv = cache_pos.reshape(-1).long()
    dev = posv.device
    posm = (posv[:, None] + torch.arange(span, device=dev)).reshape(-1)
    rows = torch.arange(posv.shape[0], device=dev).repeat_interleave(span)
    cell = block_table[rows, posm // bsz].long() * bsz + posm % bsz  # [B*S]
    order = torch.arange(cell.shape[0], device=dev)
    last = ((cell[:, None] == cell[None, :]) * order).amax(1)
    return cell, last


def _paged_write_span(cache, updates, block_table, cache_pos, cells=None):
    """Write S consecutive tokens per batch row through the block table,
    in place: ``updates[name]`` is [B, S, ...] and row r's offset i lands
    at logical position ``cache_pos[r] + i``, in physical block
    ``block_table[r, p // block_size]`` at offset ``p % block_size``.  The
    engine backs every block the span touches before the call
    (``BlockPool.check_invariants`` with a span-wide write window proves
    it).

    Masked rows (table row all trash) all write trash block 0, so several
    rows may name one cell.  No live slot's table names block 0, but the
    masked rows read it back, and in the MoE family their outputs compete
    with the live rows for expert capacity, so what the cell holds must not
    depend on which parallel write lands last.  Each cell therefore takes
    the value of its last writer in (row, offset) order, as a sequential
    write leaves it: every write to the cell carries that value.
    ``cells`` is ``_span_cells``'s result when the caller computed it."""
    if cells is None:
        cells = _span_cells(block_table, cache_pos,
                            next(iter(updates.values())).shape[1],
                            next(iter(cache.values())).shape[1])
    cell, last = cells
    for name, val in updates.items():
        val = val.reshape((-1,) + tuple(val.shape[2:]))[last]
        cache[name].view((-1,) + tuple(cache[name].shape[2:]))[cell] = \
            val.to(cache[name].dtype)
    return cache


def _paged_update_span(cache, updates, block_table, cache_pos, cells=None):
    """``_paged_write_span`` + gather each row's stream back in logical
    order: returns ``(cache, reads, length)`` with ``reads[name]`` in the
    plain layout [B, table_width * block_size, ...] — the gather read path,
    the oracle the fused kernels are held against."""
    bsz = next(iter(cache.values())).shape[1]
    b = cache_pos.reshape(-1).shape[0]
    length = block_table.shape[1] * bsz
    cache = _paged_write_span(cache, updates, block_table, cache_pos, cells)
    tbl = block_table.long()
    reads = {name: c[tbl].reshape((b, length) + tuple(c.shape[2:]))
             for name, c in cache.items()}
    return cache, reads, length


def _span_valid(cache_pos: torch.Tensor, s: int, length: int,
                window: Optional[int] = None) -> torch.Tensor:
    """[B, S, length] read mask of a span: offset i at position
    ``pos + i`` sees positions ``idx <= pos + i`` (and, with a window, only
    the last ``window`` of them)."""
    dev = cache_pos.device
    idx = torch.arange(length, device=dev)[None, None, :]
    posq = (cache_pos.reshape(-1, 1).long()
            + torch.arange(s, device=dev)[None, :])[:, :, None]
    valid = idx <= posq
    if window is not None:
        valid &= idx > posq - window
    return valid


def _paged_kv_len(cache_pos: torch.Tensor) -> torch.Tensor:
    """Valid positions per slot, the just-written token included."""
    return (cache_pos.reshape(-1) + 1).to(torch.int32)


def _rope(positions: torch.Tensor, s: int, dim: int, cfg: ArchConfig):
    """RoPE (cos, sin) at ``positions``: [B, S], or the per-slot [B] start
    of S consecutive ones."""
    if positions.dim() == 1:
        positions = positions[:, None] + torch.arange(s,
                                                      device=positions.device)
    return rope_angles(positions, dim, cfg.rope_theta)


def _ring_write(cache, updates, cache_pos):
    """Slotted decode write, in place: ``updates[name]`` [B, 1, ...] lands
    at sequence slot ``cache_pos % L`` of each batch row of ``cache[name]``
    [B, L, ...].  ``cache_pos`` is a 0-d tensor (the fixed batch, every
    row at one position) or int32 [B] (each row at its own).  For L ==
    max_len the ring is the plain append-at-pos cache."""
    for name, val in updates.items():
        c = cache[name]
        if val.shape[1] != 1:
            raise ValueError(f"slotted decode writes one token per row, got "
                             f"a span of {val.shape[1]}")
        b = c.shape[0]
        slot = (cache_pos.reshape(-1).long() % c.shape[1]).expand(b)
        c[torch.arange(b, device=c.device), slot] = val[:, 0].to(c.dtype)
    return cache


def _ring_valid(cache_pos: torch.Tensor, length: int,
                window: Optional[int] = None) -> torch.Tensor:
    """[B or 1, 1, L] read mask of a slotted decode: slot j of a length-L
    ring holds absolute position ``pos - ((pos - j) mod L)``; a negative
    one marks a slot not yet written, and a window keeps the last
    ``window`` positions."""
    idx = torch.arange(length, device=cache_pos.device)[None, :]
    posb = cache_pos.reshape(-1, 1).long()
    abs_pos = posb - torch.remainder(posb - idx, length)
    valid = abs_pos >= 0
    if window is not None:
        valid &= abs_pos > posb - window
    return valid[:, None, :]


def _gqa_read(q: torch.Tensor, reads: Dict[str, torch.Tensor],
              valid: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Attention of q [B, S, H, hd] over K/V rows in position order
    (``reads`` {"k", "v"} [B, L, kv, hd]) under the [B, S, L] mask
    ``valid``, in f32 (softcap, masked softmax) -> [B, S, H, hd] f32.  The
    gather read of the paged pool and the slotted ring share it."""
    b, s, h, hd = q.shape
    kv = reads["k"].shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    sc = torch.einsum("bshgd,blhd->bshgl", qg.float(),
                      reads["k"].float()) * hd ** -0.5
    sc = softcap(sc, cfg.softcap_attn)
    sc = torch.where(valid[:, :, None, None, :], sc,
                     torch.full_like(sc, _NEG))
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bshgl,blhd->bshgd", pr, reads["v"].float())
    return o.reshape(b, s, h, hd)


def gqa_apply(p: GQA, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor, window: Optional[int] = None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[torch.Tensor] = None,
              block_table: Optional[torch.Tensor] = None,
              return_kv: bool = False, step: Optional[PagedStep] = None):
    """x [B, S, d].  Prefill when ``cache`` is None (``return_kv`` returns
    this call's K/V); paged decode when ``cache`` (one layer's pool leaves)
    and ``block_table`` are given, with ``cache_pos`` the per-slot [B]
    position vector: one token per slot (S == 1), or a verify span of S
    tokens at positions ``cache_pos .. cache_pos + S - 1``; ``step`` is the
    forward's ``paged_step`` (else computed here).  Slotted decode when
    ``cache`` comes without a table: one token per row into the ring.
    Returns (y, new_kv)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd()
    sp = cfg.sparsity
    cos, sin = ((step.cos, step.sin) if step is not None
                else _rope(positions, s, hd, cfg))
    if step is None and cache is not None and block_table is not None:
        step = PagedStep(cos, sin, _paged_kv_len(cache_pos), _span_cells(
            block_table, cache_pos, s, cache["k"].shape[1]))
    heads = local_part("act_heads", kv)     # this rank's kv heads, if split
    if heads:
        h, kv = h // heads[0], kv // heads[0]

    q = linear_apply(p.wq, x, sp, local=bool(heads)).reshape(b, s, h, hd)
    k = linear_apply(p.wk, x, sp, local=bool(heads)).reshape(b, s, kv, hd)
    v = linear_apply(p.wv, x, sp, local=bool(heads)).reshape(b, s, kv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        o = chunked_attention(q, k, v, causal=True, window=window,
                              cap=cfg.softcap_attn, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk,
                              chain_bf16=cfg.attn_chain_bf16)
        new_kv = {"k": k, "v": v} if return_kv else None
    elif block_table is None:
        # slotted ring buffer: write at pos % L, then the gather read's
        # score chain over the whole row, masked by the ring's validity
        new_kv = _ring_write(cache, {"k": k, "v": v}, cache_pos)
        o = _gqa_read(q, new_kv, _ring_valid(cache_pos, cache["k"].shape[1],
                                             window), cfg).to(x.dtype)
    elif cfg.attn_impl == "fused":
        # write through the table, then the kernel walks the table itself —
        # the pool is never copied into position order.  A verify span
        # (S > 1) is one launch scoring offset i against kv_len + i
        new_kv = _paged_write_span(cache, {"k": k, "v": v}, block_table,
                                   cache_pos, step.cells)
        kw = dict(scale=hd ** -0.5, window=window, cap=cfg.softcap_attn)
        if s == 1:
            o = paged_gqa_decode(q.reshape(b, kv, h // kv, hd), new_kv["k"],
                                 new_kv["v"], block_table, step.kv_len, **kw)
        else:
            o = paged_gqa_verify(q.reshape(b, s, kv, h // kv, hd),
                                 new_kv["k"], new_kv["v"], block_table,
                                 step.kv_len, **kw)
        o = o.reshape(b, s, h, hd).to(x.dtype)
    elif cfg.attn_impl == "gather":
        new_kv, reads, length = _paged_update_span(
            cache, {"k": k, "v": v}, block_table, cache_pos, step.cells)
        o = _gqa_read(q, reads, _span_valid(cache_pos, s, length, window),
                      cfg).to(x.dtype)
    else:
        raise ValueError(f"attn_impl must be 'gather' or 'fused', got "
                         f"{cfg.attn_impl!r}")

    y = linear_apply(p.wo, _whole_heads(o.reshape(b, s, h * hd), heads), sp)
    return y, new_kv


def _whole_heads(o: torch.Tensor, heads) -> torch.Tensor:
    """[..., local heads x d] -> every head's (an all-gather of the heads,
    rank order = head order) when ``heads`` split them, else ``o``."""
    if not heads:
        return o
    return all_gather_last(o, require_mesh("split attention heads"))


# ------------------------------------------------------------------------ MLA

class MLA(nn.Module):
    def __init__(self, wq: SparseLinear, wdkv: SparseLinear,
                 wuk: SparseLinear, wuv: SparseLinear, wo: SparseLinear):
        super().__init__()
        self.wq, self.wdkv, self.wuk, self.wuv, self.wo = wq, wdkv, wuk, wuv, wo


def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype,
             device="cuda") -> MLA:
    d, h, sp = cfg.d_model, cfg.n_heads, cfg.sparsity
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return MLA(linear_init(gen, d, h * qk, sp, dtype, device),
               linear_init(gen, d, cfg.kv_lora + cfg.qk_rope_dim, sp, dtype,
                           device),
               linear_init(gen, cfg.kv_lora, h * cfg.qk_nope_dim, sp, dtype,
                           device),
               linear_init(gen, cfg.kv_lora, h * cfg.v_head_dim, sp, dtype,
                           device),
               linear_init(gen, h * cfg.v_head_dim, d, sp, dtype, device))


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Plain latent cache leaves: ckv [batch, max_len, kv_lora], kpe
    [batch, max_len, qk_rope_dim]."""
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                               device=device),
            "kpe": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                               dtype=dtype, device=device)}


def _mla_qkv(p: MLA, x, cfg: ArchConfig, cos, sin, h: int,
             local: bool = False):
    b, s, _ = x.shape
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    sp = cfg.sparsity
    q = linear_apply(p.wq, x, sp, local=local).reshape(b, s, h, nd + rd)
    qn, qpe = q[..., :nd], q[..., nd:]
    dkv = linear_apply(p.wdkv, x, sp)
    ckv, kpe = dkv[..., :cfg.kv_lora], dkv[..., cfg.kv_lora:]
    qpe = apply_rope(qpe, cos, sin)
    kpe = apply_rope(kpe[..., None, :], cos, sin)[..., 0, :]   # one kv head
    return qn, qpe, ckv, kpe


def _dense_weight(p: SparseLinear, cfg: ArchConfig,
                  local: bool = False) -> torch.Tensor:
    """Dense view of a (possibly compressed or masked) linear weight,
    consistent with what ``linear_apply`` multiplies by: with ``local``
    this rank's 1/n of its rows (the local heads), else all of them (a
    row shard's are all-gathered)."""
    w = dense_view(p, cfg.sparsity)
    if not getattr(p, "tp_rows", None) and not local:
        return w
    mesh = require_mesh("a split MLA weight")
    if getattr(p, "tp_rows", None):
        return w if local else all_gather(w, mesh).reshape(
            (whole_rows(p),) + tuple(w.shape[1:]))
    part = w.shape[0] // mesh.size
    return w.narrow(0, mesh.rank * part, part)


def mla_apply(p: MLA, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[torch.Tensor] = None,
              block_table: Optional[torch.Tensor] = None,
              return_kv: bool = False, step: Optional[PagedStep] = None):
    """x [B, S, d].  Prefill when ``cache`` is None (``return_kv`` returns
    this call's latent cache entries {"ckv", "kpe"}); paged decode when
    ``cache`` (one layer's pool leaves) and ``block_table`` are given, with
    ``cache_pos`` the per-slot [B] position vector: one token per slot
    (S == 1), or a verify span of S tokens at positions ``cache_pos ..
    cache_pos + S - 1``; ``step`` is the forward's ``paged_step`` (else
    computed here).  Slotted decode when ``cache`` comes without a table:
    one token per row, written at its position.  Returns (y, new_kv)."""
    b, s, _ = x.shape
    h, nd, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    vd, r = cfg.v_head_dim, cfg.kv_lora
    sp = cfg.sparsity
    cos, sin = ((step.cos, step.sin) if step is not None
                else _rope(positions, s, rd, cfg))
    if step is None and cache is not None and block_table is not None:
        step = PagedStep(cos, sin, _paged_kv_len(cache_pos), _span_cells(
            block_table, cache_pos, s, cache["ckv"].shape[1]))
    whole_h = h
    heads = local_part("act_heads", h)      # this rank's heads, if split
    if heads:
        h //= heads[0]
    loc = bool(heads)
    qn, qpe, ckv, kpe = _mla_qkv(p, x, cfg, cos, sin, h, loc)
    scale = (nd + rd) ** -0.5

    if cache is None:
        # up-project and run standard chunked attention (dq nd+rd != dv vd)
        kn = linear_apply(p.wuk, ckv, sp, local=loc).reshape(b, s, h, nd)
        vv = linear_apply(p.wuv, ckv, sp, local=loc).reshape(b, s, h, vd)
        q = torch.cat([qn, qpe], dim=-1)
        # the shared rope key meets only this rank's heads: its cotangent
        # is this rank's part of the sum over the heads
        kpe_h = reduce_grad(kpe, require_mesh("split MLA heads")) \
            if loc else kpe
        k = torch.cat([kn, kpe_h[:, :, None, :].expand(b, s, h, rd)], dim=-1)
        o = chunked_attention(q, k, vv, causal=True, scale=scale,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                              chain_bf16=cfg.attn_chain_bf16)
        new_kv = {"ckv": ckv, "kpe": kpe} if return_kv else None
    else:
        # absorbed decode in the latent space: the cache stays [kv_lora +
        # rope] per token (MLA's memory win).  S == 1 is one token per
        # slot; S > 1 a verify span whose offset i masks to idx <= pos + i.
        # Slotted caches (no block table) take one token per row, written
        # at its position, and read through the gather chain
        wuk3 = _dense_weight(p.wuk, cfg, loc).reshape(h, nd, r)
        wuv3 = _dense_weight(p.wuv, cfg, loc).reshape(h, vd, r)
        # the kernels read dense rows; this einsum returns a permuted
        # [h, b, s, r] product
        qlat = torch.einsum("bshd,hdr->bshr", qn.float(),
                            wuk3.float()).contiguous()
        qp = qpe.float().contiguous()
        upd = {"ckv": ckv, "kpe": kpe}
        if block_table is None or cfg.attn_impl == "gather":
            if block_table is None:
                new_kv = reads = _ring_write(cache, upd, cache_pos)
                length = cache["ckv"].shape[1]
            else:
                new_kv, reads, length = _paged_update_span(
                    cache, upd, block_table, cache_pos, step.cells)
            cc = reads["ckv"].float()
            sc = (torch.einsum("bshr,blr->bshl", qlat, cc)
                  + torch.einsum("bshd,bld->bshl", qp, reads["kpe"].float()))
            sc = sc * scale
            sc = torch.where(_span_valid(cache_pos, s, length)[:, :, None, :],
                             sc, torch.full_like(sc, _NEG))
            ov = torch.einsum("bshl,blr->bshr", torch.softmax(sc, dim=-1), cc)
        elif cfg.attn_impl == "fused":
            # write through the table, then the kernel walks it: scores,
            # softmax and the latent context never leave the kernel
            new_kv = _paged_write_span(cache, upd, block_table, cache_pos,
                                       step.cells)
            if s == 1:
                ov = paged_mla_decode(qlat[:, 0], qp[:, 0], new_kv["ckv"],
                                      new_kv["kpe"], block_table, step.kv_len,
                                      scale=scale, plan_h=whole_h)[:, None]
            else:
                ov = paged_mla_verify(qlat, qp, new_kv["ckv"], new_kv["kpe"],
                                      block_table, step.kv_len, scale=scale)
        else:
            raise ValueError(f"attn_impl must be 'gather' or 'fused', got "
                             f"{cfg.attn_impl!r}")
        o = torch.einsum("bshr,hdr->bshd", ov, wuv3.float()).to(x.dtype)

    y = linear_apply(p.wo, _whole_heads(o.reshape(b, s, h * vd), heads), sp)
    return y, new_kv


# ---------------------------------------------------------- cross-attention

def cross_attn_init(gen: torch.Generator, cfg: ArchConfig, dtype,
                    device="cuda") -> GQA:
    return gqa_init(gen, cfg, dtype, device)


def cross_attn_apply(p: GQA, x: torch.Tensor,
                     enc_kv: Tuple[torch.Tensor, torch.Tensor],
                     cfg: ArchConfig) -> torch.Tensor:
    """Decoder cross-attention of x [B, S, d] over precomputed encoder K/V
    [B, Se, kv, hd]: no RoPE, no mask.  Under a mesh that splits the kv
    heads, ``enc_kv`` holds this rank's (``cross_kv``) and so do the
    queries; the heads are gathered before ``wo``."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd()
    sp = cfg.sparsity
    heads = local_part("act_heads", cfg.n_kv)
    if heads:
        h //= heads[0]
    q = linear_apply(p.wq, x, sp, local=bool(heads)).reshape(b, s, h, hd)
    k, v = enc_kv
    o = chunked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk,
                          chain_bf16=cfg.attn_chain_bf16)
    return linear_apply(p.wo, _whole_heads(o.reshape(b, s, h * hd), heads),
                        sp)


def cross_kv(p: GQA, enc_out: torch.Tensor, cfg: ArchConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V [B, Se, kv, hd] from the encoder output (once
    per request); under a mesh that splits the kv heads, this rank's."""
    b, se, _ = enc_out.shape
    kv, hd = cfg.n_kv, cfg.hd()
    sp = cfg.sparsity
    heads = local_part("act_heads", kv)
    if heads:
        kv //= heads[0]
    k = linear_apply(p.wk, enc_out, sp, local=bool(heads)).reshape(b, se, kv,
                                                                    hd)
    v = linear_apply(p.wv, enc_out, sp, local=bool(heads)).reshape(b, se, kv,
                                                                    hd)
    return k, v
