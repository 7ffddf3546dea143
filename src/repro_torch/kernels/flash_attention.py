"""Fused paged GQA decode attention (flash-decoding over the block pool).

Kernel: ``csrc/paged_gqa_decode.cu`` (CUDA C++, sm_90a).  It replaces the TPU
kernel ``repro/kernels/flash_attention.py::paged_gqa_decode``
(``_paged_gqa_body``).  On the H100 it is bound by device-memory bytes: each
K/V position a slot owns is read once, against 2*(d+dv) FLOPs per query
row.  Design: one CTA per (slot, kv head) keeps the G query rows of that kv
head in shared memory and walks the slot's block table itself, stopping at
``ceil(kv_len / block_size)`` (the TPU's trailing table entries are fully
masked, so stopping there gives its result).  Each step loads one physical
K/V block into shared memory; the m/l/acc online-softmax state stays in
f32; the kv_len mask, the sliding window and the softcap are applied
exactly as the reference body applies them.  Output is float32.

``paged_gqa_decode_plain`` is the same function in plain torch (gather the
table, masked softmax): the CPU path, and what the kernel is held against
on the card.  The flash-attention prefill kernel, the MLA decode kernel and
the speculative verify spans are not on this slice's path and are not
ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel,
                                       check_cuda_operand)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("paged_gqa_decode", "paged_gqa_decode_launch",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _F, _I, _F, _I])
_NEG = -1e30
_THREADS, _MAX_PAIRS, _SMEM_LIMIT = 128, 8, 48 * 1024


def paged_gqa_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           kv_len: torch.Tensor, *, scale: float,
                           window: Optional[int] = None,
                           cap: Optional[float] = None) -> torch.Tensor:
    """Gather each slot's table back into position order, then a masked
    f32 softmax: q [B, KVH, G, d] -> [B, KVH, G, dv] float32."""
    b, kvh, g, d = q.shape
    bs = k_pool.shape[1]
    length = block_table.shape[1] * bs
    tbl = block_table.long()
    kr = k_pool[tbl].reshape(b, length, kvh, -1).float()
    vr = v_pool[tbl].reshape(b, length, kvh, -1).float()
    s = torch.einsum("bhgd,blhd->bhgl", q.float(), kr) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    kpos = torch.arange(length, device=q.device).unsqueeze(0)
    lens = kv_len.long().unsqueeze(1)
    valid = kpos < lens
    if window is not None:
        valid &= kpos > lens - 1 - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgl,blhd->bhgd", p, vr)


def paged_gqa_decode(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     kv_len: torch.Tensor, *, scale: Optional[float] = None,
                     window: Optional[int] = None,
                     cap: Optional[float] = None) -> torch.Tensor:
    """q [B, KVH, G, d] (one token per slot, grouped by kv head), k_pool /
    v_pool [n_blocks, bs, KVH, d|dv], block_table int32 [B, T], kv_len int32
    [B] (valid positions, current token included) -> [B, KVH, G, dv] f32.
    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    ``paged_gqa_decode_plain``."""
    b, kvh, g, d = q.shape
    nb, bs = k_pool.shape[:2]
    dv = v_pool.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if not q.is_cuda:
        return paged_gqa_decode_plain(q, k_pool, v_pool, block_table, kv_len,
                                      scale=scale, window=window, cap=cap)
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"paged_gqa_decode takes float32/bfloat16, got "
                         f"{q.dtype}")
    if k_pool.shape != (nb, bs, kvh, d) or v_pool.shape[:3] != (nb, bs, kvh):
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_table.shape[0] != b or kv_len.shape != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not match batch {b}")
    if cap is not None and cap <= 0:
        raise ValueError(f"softcap must be positive, got {cap}")
    if g * dv > _THREADS * _MAX_PAIRS:
        raise ValueError(f"G*dv = {g * dv} exceeds the kernel's "
                         f"{_THREADS * _MAX_PAIRS} accumulators per CTA")
    smem = (g * d + bs * d + bs * dv + g * bs + 3 * g) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_gqa_decode needs {smem} B of shared memory "
                         f"per CTA (block_size {bs}, d {d}, dv {dv}); the "
                         f"kernel takes at most {_SMEM_LIMIT}")
    check_cuda_operand("q", q, q.device)
    check_cuda_operand("k_pool", k_pool, q.device, q.dtype)
    check_cuda_operand("v_pool", v_pool, q.device, q.dtype)
    check_cuda_operand("block_table", block_table, q.device, torch.int32)
    check_cuda_operand("kv_len", kv_len, q.device, torch.int32)
    out = torch.empty(b, kvh, g, dv, dtype=torch.float32, device=q.device)
    if b and kvh:
        KERNEL.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                      block_table.data_ptr(), kv_len.data_ptr(),
                      out.data_ptr(), b, kvh, g, d, dv, bs,
                      block_table.shape[1], float(scale),
                      -1 if window is None else int(window),
                      0.0 if cap is None else float(cap),
                      DTYPE_CODES[q.dtype])
    return out


def paged_decode_traffic(b: int, table_width: int, block_size: int,
                         kv_lens, d: int, dv: int, *,
                         dtype_bytes: int = 2) -> dict:
    """Per-step KV traffic model, fused vs gather: the gather path
    materializes every slot's full table span (pool read + copy write +
    attention read = 3 passes over T*bs positions per slot); the fused walk
    reads each owned block once — ceil(kv_len/bs)*bs positions per slot."""
    span = table_width * block_size
    per_pos = (d + dv) * dtype_bytes
    gather = 3 * b * span * per_pos
    fused = sum(-(-int(n) // block_size) * block_size for n in kv_lens) \
        * per_pos
    return dict(gather_bytes=gather, fused_bytes=fused,
                ratio=fused / max(gather, 1))
