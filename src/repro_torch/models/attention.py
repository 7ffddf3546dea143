"""GQA attention and its paged KV cache (counterpart of the GQA half of
``repro.models.attention``).

Prefill runs ``chunked_attention``, a plain-torch online-softmax attention
over (q_chunk, kv_chunk) tiles.  Decode is one token per slot against the
paged block pool, read either by the fused ``paged_gqa_decode`` kernel
(``cfg.attn_impl == "fused"``) or by gathering each slot's blocks back into
position order first (``"gather"``, the oracle).

Query head ``h`` uses kv head ``h // G`` (G = n_heads // n_kv) in prefill
and decode alike.  Decode writes the new token's K/V into the pool **in
place** (``_paged_write``); the reference returned a new pool instead.
MLA, cross-attention, the slotted (ring-buffer) decode cache and the
speculative verify spans are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core.layers import SparseLinear, linear_apply, linear_init
from repro_torch.kernels.flash_attention import paged_gqa_decode
from repro_torch.models.common import apply_rope, rope_angles, softcap
from repro_torch.models.config import ArchConfig

_NEG = -1e30


def _pick_chunk(s: int, want: int) -> int:
    c = min(want, s)
    while s % c:
        c -= 1
    return c


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      cap: Optional[float] = None,
                      scale: Optional[float] = None, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention in f32.

    q [B, Sq, H, Dq], k [B, Sk, KVH, Dq], v [B, Sk, KVH, Dv]; H % KVH == 0
    and query head h reads kv head h // (H // KVH).  Returns [B, Sq, H, Dv]
    in v.dtype.  The q tokens occupy positions Sk - Sq ... Sk - 1.
    """
    b, sq, h, dq = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    scale = scale if scale is not None else dq ** -0.5
    cq, ck = _pick_chunk(sq, q_chunk), _pick_chunk(sk, kv_chunk)
    nq, nk = sq // cq, sk // ck
    q_off = sk - sq
    dev = q.device
    qg = q.reshape(b, nq, cq, kvh, g, dq).permute(1, 0, 3, 4, 2, 5).float()
    kc = k.reshape(b, nk, ck, kvh, dq).permute(1, 0, 3, 2, 4).float()
    vc = v.reshape(b, nk, ck, kvh, dv).permute(1, 0, 3, 2, 4).float()
    outs = []
    for qi in range(nq):
        qpos = q_off + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, kvh, g, cq), _NEG, device=dev)
        l = torch.zeros((b, kvh, g, cq), device=dev)
        acc = torch.zeros((b, kvh, g, cq, dv), device=dev)
        for ki in range(nk):
            kpos = ki * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qg[qi], kc[ki]) * scale
            s = softcap(s, cap)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vc[ki])
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])   # [b, kvh, g, cq, dv]
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, dv)
    return out.to(v.dtype)


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
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Plain (position-indexed) KV cache leaves [batch, max_len, kv, hd]."""
    z = torch.zeros((batch, max_len, cfg.n_kv, cfg.hd()), dtype=dtype,
                    device=device)
    return {"k": z, "v": z.clone()}


def _paged_write(cache, updates, block_table, cache_pos):
    """Write one new token per batch row through the block table, in place.

    Cache leaves are block pools [n_blocks, block_size, ...]; row r's token
    at position p lives at physical block ``block_table[r, p // block_size]``,
    offset ``p % block_size``.  Idle rows (table row all trash, position 0)
    all write trash block 0; duplicate writes there are harmless because no
    live slot's table names block 0 (``BlockPool.check_invariants``)."""
    bsz = next(iter(cache.values())).shape[1]
    posv = cache_pos.reshape(-1).long()
    rows = torch.arange(posv.shape[0], device=posv.device)
    blk = block_table[rows, posv // bsz].long()
    off = posv % bsz
    for name, val in updates.items():
        cache[name][blk, off] = val.to(cache[name].dtype)
    return cache


def _paged_update(cache, updates, block_table, cache_pos):
    """``_paged_write`` + gather each row's stream back in logical order:
    returns ``(cache, reads, length)`` with ``reads[name]`` in the plain
    layout [B, table_width * block_size, ...] — the gather read path, the
    oracle the fused kernel is held against."""
    bsz = next(iter(cache.values())).shape[1]
    b = cache_pos.reshape(-1).shape[0]
    length = block_table.shape[1] * bsz
    cache = _paged_write(cache, updates, block_table, cache_pos)
    tbl = block_table.long()
    reads = {name: c[tbl].reshape((b, length) + tuple(c.shape[2:]))
             for name, c in cache.items()}
    return cache, reads, length


def _paged_kv_len(cache_pos: torch.Tensor) -> torch.Tensor:
    """Valid positions per slot, the just-written token included."""
    return (cache_pos.reshape(-1) + 1).to(torch.int32)


def gqa_apply(p: GQA, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor, window: Optional[int] = None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[torch.Tensor] = None,
              block_table: Optional[torch.Tensor] = None,
              return_kv: bool = False):
    """x [B, S, d].  Prefill when ``cache`` is None (``return_kv`` returns
    this call's K/V); single-token paged decode when ``cache`` (one layer's
    pool leaves) and ``block_table`` are given, with ``cache_pos`` the
    per-slot [B] position vector.  Returns (y, new_kv)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd()
    sp = cfg.sparsity
    if positions.dim() == 1:
        positions = positions[:, None] + torch.arange(s, device=x.device)

    q = linear_apply(p.wq, x, sp).reshape(b, s, h, hd)
    k = linear_apply(p.wk, x, sp).reshape(b, s, kv, hd)
    v = linear_apply(p.wv, x, sp).reshape(b, s, kv, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        o = chunked_attention(q, k, v, causal=True, window=window,
                              cap=cfg.softcap_attn, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        new_kv = {"k": k, "v": v} if return_kv else None
    elif block_table is None or s != 1:
        raise NotImplementedError(
            "slotted decode caches and multi-token verify spans come with "
            "later slices of the port; decode here is paged, one token")
    elif cfg.attn_impl == "fused":
        # fused paged decode: write through the table, then the kernel walks
        # the table itself — the pool is never copied into position order
        new_kv = _paged_write(cache, {"k": k[:, 0], "v": v[:, 0]},
                              block_table, cache_pos)
        o = paged_gqa_decode(q.reshape(b, kv, h // kv, hd), new_kv["k"],
                             new_kv["v"], block_table,
                             _paged_kv_len(cache_pos), scale=hd ** -0.5,
                             window=window, cap=cfg.softcap_attn)
        o = o.reshape(b, 1, h, hd).to(x.dtype)
    elif cfg.attn_impl == "gather":
        new_kv, reads, length = _paged_update(
            cache, {"k": k[:, 0], "v": v[:, 0]}, block_table, cache_pos)
        qg = q.reshape(b, kv, h // kv, hd)
        sc = torch.einsum("bhgd,blhd->bhgl", qg.float(),
                          reads["k"].float()) * hd ** -0.5
        sc = softcap(sc, cfg.softcap_attn)
        idx = torch.arange(length, device=x.device)[None, :]
        posb = cache_pos.reshape(-1, 1).long()
        abs_pos = posb - torch.remainder(posb - idx, length)
        valid = abs_pos >= 0
        if window is not None:
            valid &= abs_pos > posb - window
        sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, _NEG))
        pr = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhgl,blhd->bhgd", pr, reads["v"].float())
        o = o.reshape(b, 1, h, hd).to(x.dtype)
    else:
        raise ValueError(f"attn_impl must be 'gather' or 'fused', got "
                         f"{cfg.attn_impl!r}")

    y = linear_apply(p.wo, o.reshape(b, s, h * hd), sp)
    return y, new_kv
