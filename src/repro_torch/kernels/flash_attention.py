"""Fused attention kernels: paged decode and verify (flash-decoding over the
block pool, GQA and MLA), and flash attention over dense [BH, S, D].

Each family has one kernel, which scores a span of S >= 1 consecutive
queries per slot (offset i sees ``kv_len + i`` positions); the one-token
decode is the span S = 1.  ``paged_*_decode`` and ``paged_*_verify`` both
launch it, each with its own launch counter (``KERNEL`` / ``MLA_KERNEL``
and ``GQA_VERIFY_KERNEL`` / ``MLA_VERIFY_KERNEL``).

GQA kernel: ``csrc/paged_gqa_verify.cu`` (CUDA C++, sm_90a).  It replaces
the TPU kernels ``repro/kernels/flash_attention.py::paged_gqa_decode``
(``_paged_gqa_body``) and ``::paged_gqa_verify`` (one decode launch per
span offset).  MLA kernel: ``csrc/paged_mla_verify.cu``; it replaces
``paged_mla_decode`` (``_paged_mla_body``) and ``paged_mla_verify``:
absorbed MLA in the latent space, scores ``(q_lat . ckv + q_pe . kpe) *
scale`` and the latent cache itself as the value.  Both are bound by
device-memory bytes (each cache position a slot owns is read once; under
a microsecond at the serving shape), and at 8 slots both are latency-bound
launches.  Each row applies its own ``kv_len + i`` mask (GQA also the
sliding window and the softcap) as the reference body does; a row that
sees nothing gives 0.  Output is float32.

The launch is cut in Python (``gqa_plan`` / ``mla_plan``; the C launchers
only check it).  bf16 pools at the models' widths take the tensor-core
bodies: the KV axis is cut into chunks of ``CHUNK`` (64) positions fixed in
absolute position, a CTA per chunk that copies its K/V (or latent) tile
into shared memory with 16-byte ``cp.async``, all at once, and runs Q K^T
and P V on ``mma.sync`` (P, and MLA's f32 queries, split into hi + lo
bf16, so the products stay within 2e-4).  GQA: a CTA per (chunk, slot x kv
head, up to 4 span rows), a warp per span row, its G query rows one m
tile.  MLA: a CTA of 8 warps per (chunk, span row, slot) holding the
row's H heads, so each latent block is read once per span row rather than
once per head.  A row whose view spans several chunks parks each chunk's
partial (m, l, acc) in a workspace the wrapper allocates, and the last of
its chunks to arrive (int counters, zero between launches) folds them in
chunk order.  f32 pools and other shapes take the first bodies: a CTA per
(slot, kv head) or (slot, head) walks the slot's table block by block on
CUDA cores.

Each span row reduces in an order that depends only on its own length
(and window) and query, never on S or the other rows, so verify offset i
equals a decode launch at ``kv_len + i`` bit for bit.

Flash attention kernel: ``csrc/flash_attention.cu`` (CUDA C++, sm_90a),
launched by ``flash_attention_kernel`` (counter ``FLASH_KERNEL``).  It
replaces ``repro/kernels/flash_attention.py::flash_attention_kernel``
(``_fa_body``) with its semantics: scale, softcap, then the causal / window
mask anchored at ``q_off`` (default ``Sk - Sq``), masked scores forced to
p = 0, f32 online softmax, output ``acc / max(l, 1e-30)`` (a row masked
everywhere gives 0).  Bound by operations at prefill widths.  bf16 with
d and dv multiples of 16 (up to 256) runs on the tensor cores: one CTA of
4 warps per (bh, 64-row q tile), 16 rows a warp, K / V tiles of 64 keys
(32 at dv > 128) through a two-stage ``cp.async`` ring, ``mma.sync`` for
Q K^T and P V with the scores and P kept in registers, and the key tiles
outside the q tile's causal / window band skipped (they are masked for
every row, so skipping them changes nothing).  f32, and other bf16
shapes, keep the first body: one CTA per (bh, 32-row q tile) over 32-key
tiles staged in f32 shared memory, lane j scoring key j, f32 FMAs, no
tile skipped.  As in the reference, the models prefill with
``chunked_attention``; this kernel is a public entry point that no model
path calls.

``*_plain`` are the same functions in plain torch (gather the table, masked
softmax; for flash, one masked f32 softmax over the whole key axis): the
CPU path, and what the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel,
                                       check_cuda_operand)
from repro_torch.kernels.nm_spmv import _arrivals
from repro_torch.launch.op_cost import counted, operand_bytes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# + the plan: body, chunk, rows, threads, smem, grid x / y / z, workspace,
# arrival counters
_PLAN_ARGS = [_I] * 8 + [_P, _P]
_GQA_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
             _F, _I] + _PLAN_ARGS
_MLA_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
             _I] + _PLAN_ARGS
# one kernel per family; the decode and verify wrappers count separately
KERNEL = CudaKernel("paged_gqa_decode", "paged_gqa_verify_launch", _GQA_ARGS,
                    lib="paged_gqa_verify")
MLA_KERNEL = CudaKernel("paged_mla_decode", "paged_mla_verify_launch",
                        _MLA_ARGS, lib="paged_mla_verify")
GQA_VERIFY_KERNEL = CudaKernel("paged_gqa_verify", "paged_gqa_verify_launch",
                               _GQA_ARGS)
MLA_VERIFY_KERNEL = CudaKernel("paged_mla_verify", "paged_mla_verify_launch",
                               _MLA_ARGS)
FLASH_KERNEL = CudaKernel("flash_attention", "flash_attention_launch",
                          [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                           _F, _I, _I])
_FLASH_MAX_D = 256
_NEG = -1e30
DEFAULT_BLOCK_FA = (512, 1024)      # (bq, bk) of the reference flash tile
SMEM_LIMIT = 232448                 # opt-in dynamic shared memory per CTA
CHUNK = 64             # positions per chunk of the tensor-core bodies
GQA_SPAN_ROWS = 4      # span rows (one warp each) per CTA, GQA tensor cores
MLA_WARPS = 8          # warps per CTA, MLA tensor cores
MLA_MAX_DEPTH = 640    # r + rd: a thread holds its query loads in flight
TILE = 16              # query rows of one mma m tile (G or H at most)
_FIRST_THREADS, _FIRST_ACC = 128, 8   # first bodies: accumulators / thread
_MLA_FIRST_ROWS = 4    # span rows per CTA of the first MLA body (S > 1)


class PagedPlan(NamedTuple):
    """One paged attention launch as cut by ``gqa_plan`` / ``mla_plan``
    (the C launcher only checks it).  ``body`` is "tc" (tensor cores: the
    KV axis in chunks of ``chunk`` positions fixed in absolute position,
    a CTA per chunk) or "first" (CUDA cores: a CTA walks a slot's whole
    table).  ``rows`` are the span rows per CTA (tc GQA: one warp each;
    first GQA: query rows), ``ws`` the f32 elements of the chunk partials'
    workspace and ``counters`` the int32 arrival counters (both 0 when every
    row's view fits one chunk, or on the first body)."""
    body: str
    chunk: int
    rows: int
    threads: int
    smem: int
    grid: Tuple[int, int, int]
    ws: int
    counters: int

    def args(self) -> Tuple[int, ...]:
        """The plan's ints in the launcher's order."""
        return (int(self.body == "tc"), self.chunk, self.rows, self.threads,
                self.smem, *self.grid)


def table_chunks(tw: int, bs: int) -> int:
    """Chunks of ``CHUNK`` positions along a table of ``tw`` blocks."""
    return max(1, -(-tw * bs // CHUNK))


def row_chunks(kv_len: int, tw: int, bs: int,
               window: Optional[int] = None) -> range:
    """The chunks that hold what a row seeing ``kv_len`` positions attends
    to (``kv_len - window <= pos < min(kv_len, tw * bs)``); a row that sees
    nothing gets chunk 0, all of it masked.  The tensor-core kernels visit
    these for the row and fold them in this order."""
    top = min(kv_len, tw * bs)
    lo = max(0, kv_len - window) if window is not None else 0
    if lo >= top:
        return range(0, 1)
    return range(lo // CHUNK, -(-top // CHUNK))


@functools.lru_cache(maxsize=1024)
def gqa_plan(b: int, s: int, kvh: int, g: int, d: int, dv: int, bs: int,
             tw: int, dtype: torch.dtype, aligned: bool = True) -> PagedPlan:
    """The launch of the GQA kernel for q [b, s, kvh, g, d] over a table of
    ``tw`` blocks of ``bs``.  The tensor-core body takes bf16 with d, dv
    multiples of 16 up to 256, g <= 16, a block size dividing the chunk and
    16-byte aligned operands: a CTA of 4 warps per (chunk, slot x kv head,
    group of up to 4 span rows), a warp per span row; all 4 warps copy the
    chunk, also at s = 1.  Everything else takes the first body.  The chunk
    is the same at every s, so a row's chunks are too.  At d = dv = 256
    (gemma2-9b) a CTA asks 76032 B of shared memory at one span row and
    101376 B at four, the most any shape it takes asks, within
    ``SMEM_LIMIT``."""
    if (dtype == torch.bfloat16 and d % 16 == 0 and dv % 16 == 0
            and d <= 256 and dv <= 256 and g <= TILE and CHUNK % bs == 0
            and aligned):
        chunks = table_chunks(tw, bs)
        groups = -(-s // GQA_SPAN_ROWS)
        rows = -(-s // groups)
        smem = 2 * (CHUNK * (d + 8) + CHUNK * (dv + 8) + rows * TILE * (d + 8))
        split = chunks > 1
        return PagedPlan("tc", CHUNK, rows, 32 * GQA_SPAN_ROWS, smem,
                         (chunks, b * kvh, groups),
                         b * kvh * s * chunks * g * (dv + 2) if split else 0,
                         b * kvh * s if split else 0)
    if dv > _FIRST_THREADS * _FIRST_ACC:
        raise ValueError(f"paged GQA: dv = {dv} exceeds the first body's "
                         f"{_FIRST_THREADS * _FIRST_ACC} accumulators per CTA")
    rows = min(s * g, _FIRST_THREADS * _FIRST_ACC // dv)
    smem = (rows * d + bs * d + bs * dv + rows * bs + 5 * rows) * 4
    return PagedPlan("first", 0, rows, _FIRST_THREADS, smem,
                     (b * kvh, -(-s * g // rows), 1), 0, 0)


@functools.lru_cache(maxsize=1024)
def mla_plan(b: int, s: int, h: int, r: int, rd: int, bs: int, tw: int,
             dtype: torch.dtype, aligned: bool = True,
             plan_h: Optional[int] = None) -> PagedPlan:
    """The launch of the MLA kernel for q_lat [b, s, h, r] and q_pe
    [b, s, h, rd] over a table of ``tw`` blocks of ``bs``.  The tensor-core
    body takes bf16 pools with r, rd multiples of 16, r <= 512, r + rd <=
    640, h <= 16, a block size dividing the chunk and 16-byte aligned
    operands: a CTA of 8 warps per (chunk, span row, slot) holding the
    row's h heads.  Everything else takes the first body.  ``plan_h`` is
    the whole head count when q holds a shard of the heads
    (tensor-parallel serving): the body is the one the whole launch takes,
    so each head sums in the same order; grid and workspace follow h.
    (``gqa_plan`` needs no such argument: no part of it but the grid and
    the workspace depends on the kv head count.)"""
    smem = (2 * ((2 * TILE + CHUNK) * (r + rd + 8) + 2 * TILE * (CHUNK + 8))
            + 4 * (TILE * CHUNK + 2 * TILE))
    if (dtype == torch.bfloat16 and r % 16 == 0 and rd % 16 == 0
            and r <= 512 and r + rd <= MLA_MAX_DEPTH
            and (plan_h or h) <= TILE
            and CHUNK % bs == 0 and aligned and smem <= SMEM_LIMIT):
        chunks = table_chunks(tw, bs)
        split = chunks > 1
        return PagedPlan("tc", CHUNK, 1, 32 * MLA_WARPS, smem, (chunks, s, b),
                         b * s * chunks * h * (r + 2) if split else 0,
                         b * s if split else 0)
    if r > _FIRST_THREADS * _FIRST_ACC:
        raise ValueError(f"paged MLA: kv_lora {r} exceeds the first body's "
                         f"{_FIRST_THREADS * _FIRST_ACC} accumulators per CTA")
    most = 1 if s == 1 else _MLA_FIRST_ROWS
    rows = min(s, most)
    smem = ((r + rd) * (rows + bs) + rows * bs) * 4
    return PagedPlan("first", 0, rows, _FIRST_THREADS, smem,
                     (b * h, -(-s // most), 1), 0, 0)


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _launch_planned(kernel: CudaKernel, plan: PagedPlan, device, *args
                    ) -> None:
    """Launch ``kernel`` with ``args`` and ``plan``: the workspace is
    ``torch.empty`` here and the arrival counters are zero between
    launches (the kernel resets them)."""
    fn = kernel.name
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"{fn} needs {plan.smem} B of shared memory per CTA;"
                         f" the kernel takes at most {SMEM_LIMIT}")
    ws = torch.empty(plan.ws, dtype=torch.float32, device=device) \
        if plan.ws else None
    cnt = _arrivals(device, plan.counters) if plan.counters else None
    kernel.launch(*args, *plan.args(), None if ws is None else ws.data_ptr(),
                  None if cnt is None else cnt.data_ptr())


def _gqa_cost(out, q, k_pool, v_pool, block_table, kv_len, *args, **kw):
    """Paged GQA's work over every position its table names (the same on
    the kernel and the plain path; kv_len is data, not read): 2 * query
    heads * positions * (d + dv) FLOPs, and q, the named K/V rows, the
    table, kv_len and the output once each."""
    b, length = block_table.shape[0], block_table.numel() * k_pool.shape[1]
    kv_row = (k_pool[0, 0].numel() * k_pool.element_size()
              + v_pool[0, 0].numel() * v_pool.element_size())
    d, dv = k_pool.shape[-1], v_pool.shape[-1]
    heads = q.numel() // d                  # every slot's query heads
    return (2.0 * heads * (length // b) * (d + dv),
            operand_bytes(q, block_table, kv_len, out) + length * kv_row)


def _mla_cost(out, q_lat, q_pe, ckv_pool, kpe_pool, block_table, kv_len,
              *args, **kw):
    """Paged absorbed MLA's work over every position its table names:
    2 * query heads * positions * (r + rd + r) FLOPs, and the queries, the
    named latent rows, the table, kv_len and the output once each."""
    b, length = block_table.shape[0], block_table.numel() * ckv_pool.shape[1]
    r, rd = ckv_pool.shape[-1], kpe_pool.shape[-1]
    row = (r * ckv_pool.element_size() + rd * kpe_pool.element_size())
    heads = q_lat.numel() // r
    return (2.0 * heads * (length // b) * (2 * r + rd),
            operand_bytes(q_lat, q_pe, block_table, kv_len, out)
            + length * row)


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


@counted("paged_gqa_decode", _gqa_cost)
def paged_gqa_decode(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     kv_len: torch.Tensor, *, scale: Optional[float] = None,
                     window: Optional[int] = None,
                     cap: Optional[float] = None) -> torch.Tensor:
    """q [B, KVH, G, d] (one token per slot, grouped by kv head), k_pool /
    v_pool [n_blocks, bs, KVH, d|dv], block_table int32 [B, T], kv_len int32
    [B] (valid positions, current token included) -> [B, KVH, G, dv] f32.
    A CUDA tensor launches the kernel as a span of S = 1 (or raises); a CPU
    tensor takes ``paged_gqa_decode_plain``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return paged_gqa_decode_plain(q, k_pool, v_pool, block_table, kv_len,
                                      scale=scale, window=window, cap=cap)
    return _gqa_launch(KERNEL, q, k_pool, v_pool, block_table, kv_len,
                       scale, window, cap)


def paged_mla_decode_plain(q_lat: torch.Tensor, q_pe: torch.Tensor,
                           ckv_pool: torch.Tensor, kpe_pool: torch.Tensor,
                           block_table: torch.Tensor, kv_len: torch.Tensor, *,
                           scale: float) -> torch.Tensor:
    """Gather each slot's table back into position order, then a masked
    f32 softmax in the latent space: q_lat [B, H, r], q_pe [B, H, rd] ->
    [B, H, r] float32."""
    b = q_lat.shape[0]
    bs = ckv_pool.shape[1]
    length = block_table.shape[1] * bs
    tbl = block_table.long()
    cr = ckv_pool[tbl].reshape(b, length, -1).float()
    pr = kpe_pool[tbl].reshape(b, length, -1).float()
    s = (torch.einsum("bhr,blr->bhl", q_lat.float(), cr)
         + torch.einsum("bhd,bld->bhl", q_pe.float(), pr)) * scale
    valid = (torch.arange(length, device=q_lat.device)[None, :]
             < kv_len.long()[:, None])
    s = torch.where(valid[:, None, :], s, torch.full_like(s, _NEG))
    return torch.einsum("bhl,blr->bhr", torch.softmax(s, dim=-1), cr)


@counted("paged_mla_decode", _mla_cost)
def paged_mla_decode(q_lat: torch.Tensor, q_pe: torch.Tensor,
                     ckv_pool: torch.Tensor, kpe_pool: torch.Tensor,
                     block_table: torch.Tensor, kv_len: torch.Tensor, *,
                     scale: float, plan_h: Optional[int] = None
                     ) -> torch.Tensor:
    """Fused paged MLA (absorbed) decode: q_lat [B, H, r] float32 (queries
    already in the latent space), q_pe [B, H, rd] float32, ckv_pool
    [n_blocks, bs, r], kpe_pool [n_blocks, bs, rd] (float32 or bfloat16,
    one dtype), block_table int32 [B, T], kv_len int32 [B] -> latent context
    [B, H, r] float32 (the caller up-projects through wuv).  A CUDA tensor
    launches the kernel as a span of S = 1 (or raises); a CPU tensor takes
    ``paged_mla_decode_plain``.  ``plan_h``: the whole head count of a
    head shard (``mla_plan``)."""
    if not q_lat.is_cuda:
        return paged_mla_decode_plain(q_lat, q_pe, ckv_pool, kpe_pool,
                                      block_table, kv_len, scale=scale)
    return _mla_launch(MLA_KERNEL, q_lat, q_pe, ckv_pool, kpe_pool,
                       block_table, kv_len, scale, plan_h)


def _span_lens(kv_len: torch.Tensor, s: int) -> torch.Tensor:
    """[B, S] valid positions of each span offset: kv_len + i."""
    return kv_len.long()[:, None] + torch.arange(s, device=kv_len.device)


def paged_gqa_verify_plain(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           kv_len: torch.Tensor, *, scale: float,
                           window: Optional[int] = None,
                           cap: Optional[float] = None) -> torch.Tensor:
    """Gather each slot's table back into position order, then a masked f32
    softmax per span offset: q [B, S, KVH, G, d] -> [B, S, KVH, G, dv]
    float32, offset i masked to its ``kv_len + i`` positions."""
    b, s, kvh, g, d = q.shape
    length = block_table.shape[1] * k_pool.shape[1]
    tbl = block_table.long()
    kr = k_pool[tbl].reshape(b, length, kvh, -1).float()
    vr = v_pool[tbl].reshape(b, length, kvh, -1).float()
    sc = torch.einsum("bshgd,blhd->bshgl", q.float(), kr) * scale
    if cap is not None:
        sc = cap * torch.tanh(sc / cap)
    kpos = torch.arange(length, device=q.device)[None, None, :]
    lens = _span_lens(kv_len, s)[:, :, None]
    valid = kpos < lens
    if window is not None:
        valid &= kpos > lens - 1 - window
    sc = torch.where(valid[:, :, None, None, :], sc, torch.full_like(sc, _NEG))
    return torch.einsum("bshgl,blhd->bshgd", torch.softmax(sc, dim=-1), vr)


@counted("paged_gqa_verify", _gqa_cost)
def paged_gqa_verify(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     kv_len: torch.Tensor, *, scale: Optional[float] = None,
                     window: Optional[int] = None,
                     cap: Optional[float] = None) -> torch.Tensor:
    """Fused paged GQA over a span of S consecutive queries per slot: q
    [B, S, KVH, G, d], pools and table as ``paged_gqa_decode``, kv_len int32
    [B] valid positions for span offset 0 (offset i sees ``kv_len + i``) ->
    [B, S, KVH, G, dv] float32.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes ``paged_gqa_verify_plain``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return paged_gqa_verify_plain(q, k_pool, v_pool, block_table, kv_len,
                                      scale=scale, window=window, cap=cap)
    return _gqa_launch(GQA_VERIFY_KERNEL, q, k_pool, v_pool, block_table,
                       kv_len, scale, window, cap)


def _gqa_launch(kernel: CudaKernel, q, k_pool, v_pool, block_table, kv_len,
                scale, window, cap) -> torch.Tensor:
    """Check a span's operands (q [B, S, KVH, G, d], or [B, KVH, G, d] for
    S = 1, on the card) and launch the GQA kernel through ``kernel``'s
    counter -> f32 of q's shape with dv last."""
    b, (kvh, g, d) = q.shape[0], q.shape[-3:]
    s = q.shape[1] if q.dim() == 5 else 1
    nb, bs = k_pool.shape[:2]
    dv = v_pool.shape[-1]
    fn = kernel.name
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{fn} takes float32/bfloat16, got {q.dtype}")
    if k_pool.shape != (nb, bs, kvh, d) or v_pool.shape[:3] != (nb, bs, kvh):
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_table.shape[0] != b or kv_len.shape != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not match batch {b}")
    if cap is not None and cap <= 0:
        raise ValueError(f"softcap must be positive, got {cap}")
    check_cuda_operand("q", q, q.device)
    check_cuda_operand("k_pool", k_pool, q.device, q.dtype)
    check_cuda_operand("v_pool", v_pool, q.device, q.dtype)
    check_cuda_operand("block_table", block_table, q.device, torch.int32)
    check_cuda_operand("kv_len", kv_len, q.device, torch.int32)
    tw = block_table.shape[1]
    plan = gqa_plan(b, s, kvh, g, d, dv, bs, tw, q.dtype,
                    _aligned(q, k_pool, v_pool))
    out = torch.empty(q.shape[:-1] + (dv,), dtype=torch.float32,
                      device=q.device)
    if out.numel():
        _launch_planned(
            kernel, plan, q.device, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), b, s, kvh, g, d, dv, bs, tw, float(scale),
            -1 if window is None else int(window),
            0.0 if cap is None else float(cap), DTYPE_CODES[q.dtype])
    return out


def paged_mla_verify_plain(q_lat: torch.Tensor, q_pe: torch.Tensor,
                           ckv_pool: torch.Tensor, kpe_pool: torch.Tensor,
                           block_table: torch.Tensor, kv_len: torch.Tensor, *,
                           scale: float) -> torch.Tensor:
    """Gather each slot's table back into position order, then a masked f32
    softmax in the latent space per span offset: q_lat [B, S, H, r], q_pe
    [B, S, H, rd] -> [B, S, H, r] float32, offset i masked to its
    ``kv_len + i`` positions."""
    b, s = q_lat.shape[:2]
    length = block_table.shape[1] * ckv_pool.shape[1]
    tbl = block_table.long()
    cr = ckv_pool[tbl].reshape(b, length, -1).float()
    pr = kpe_pool[tbl].reshape(b, length, -1).float()
    sc = (torch.einsum("bshr,blr->bshl", q_lat.float(), cr)
          + torch.einsum("bshd,bld->bshl", q_pe.float(), pr)) * scale
    valid = (torch.arange(length, device=q_lat.device)[None, None, :]
             < _span_lens(kv_len, s)[:, :, None])
    sc = torch.where(valid[:, :, None, :], sc, torch.full_like(sc, _NEG))
    return torch.einsum("bshl,blr->bshr", torch.softmax(sc, dim=-1), cr)


@counted("paged_mla_verify", _mla_cost)
def paged_mla_verify(q_lat: torch.Tensor, q_pe: torch.Tensor,
                     ckv_pool: torch.Tensor, kpe_pool: torch.Tensor,
                     block_table: torch.Tensor, kv_len: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """Fused paged MLA (absorbed) over a span of S consecutive queries per
    slot: q_lat [B, S, H, r] and q_pe [B, S, H, rd] float32, pools and
    table as ``paged_mla_decode``, kv_len int32 [B] valid positions for span
    offset 0 (offset i sees ``kv_len + i``) -> latent context [B, S, H, r]
    float32.  A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes ``paged_mla_verify_plain``."""
    if not q_lat.is_cuda:
        return paged_mla_verify_plain(q_lat, q_pe, ckv_pool, kpe_pool,
                                      block_table, kv_len, scale=scale)
    return _mla_launch(MLA_VERIFY_KERNEL, q_lat, q_pe, ckv_pool, kpe_pool,
                       block_table, kv_len, scale)


def _mla_launch(kernel: CudaKernel, q_lat, q_pe, ckv_pool, kpe_pool,
                block_table, kv_len, scale, plan_h=None) -> torch.Tensor:
    """Check a span's operands (q_lat [B, S, H, r], or [B, H, r] for S = 1,
    on the card) and launch the MLA kernel through ``kernel``'s counter ->
    f32 of q_lat's shape."""
    b, (h, r) = q_lat.shape[0], q_lat.shape[-2:]
    s = q_lat.shape[1] if q_lat.dim() == 4 else 1
    rd = q_pe.shape[-1]
    nb, bs = ckv_pool.shape[:2]
    fn = kernel.name
    if ckv_pool.dtype not in DTYPE_CODES:
        raise ValueError(f"{fn} takes float32/bfloat16 pools, got "
                         f"{ckv_pool.dtype}")
    if (q_pe.shape != q_lat.shape[:-1] + (rd,)
            or ckv_pool.shape != (nb, bs, r)
            or kpe_pool.shape != (nb, bs, rd)):
        raise ValueError(f"shapes q_lat {tuple(q_lat.shape)}, q_pe "
                         f"{tuple(q_pe.shape)}, ckv_pool "
                         f"{tuple(ckv_pool.shape)}, kpe_pool "
                         f"{tuple(kpe_pool.shape)} do not match")
    if block_table.shape[0] != b or kv_len.shape != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not match batch {b}")
    check_cuda_operand("q_lat", q_lat, q_lat.device, torch.float32)
    check_cuda_operand("q_pe", q_pe, q_lat.device, torch.float32)
    check_cuda_operand("ckv_pool", ckv_pool, q_lat.device)
    check_cuda_operand("kpe_pool", kpe_pool, q_lat.device, ckv_pool.dtype)
    check_cuda_operand("block_table", block_table, q_lat.device, torch.int32)
    check_cuda_operand("kv_len", kv_len, q_lat.device, torch.int32)
    tw = block_table.shape[1]
    plan = mla_plan(b, s, h, r, rd, bs, tw, ckv_pool.dtype,
                    _aligned(q_lat, q_pe, ckv_pool, kpe_pool), plan_h)
    out = torch.empty(q_lat.shape, dtype=torch.float32, device=q_lat.device)
    if out.numel():
        _launch_planned(
            kernel, plan, q_lat.device, q_lat.data_ptr(), q_pe.data_ptr(),
            ckv_pool.data_ptr(), kpe_pool.data_ptr(), block_table.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), b, s, h, r, rd, bs, tw,
            float(scale), DTYPE_CODES[ckv_pool.dtype])
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          cap: Optional[float] = None,
                          scale: Optional[float] = None,
                          q_off: Optional[int] = None) -> torch.Tensor:
    """q [BH, Sq, D], k [BH, Sk, D], v [BH, Sk, Dv] -> [BH, Sq, Dv] in
    q.dtype: one masked f32 softmax over the whole key axis with the
    kernel's semantics (masked p = 0, ``acc / max(l, 1e-30)``)."""
    sq, sk = q.shape[1], k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    q_off = sk - sq if q_off is None else q_off
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qpos = q_off + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return (out / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _flash_cost(out, q, k, v, *args, **kw):
    """2 * BH * Sq * Sk * (D + Dv) FLOPs (every tile, as the reference's
    ``flash_traffic``), q, k, v and the output once each."""
    return (2.0 * q.shape[0] * q.shape[1] * k.shape[1]
            * (q.shape[2] + v.shape[2]), operand_bytes(q, k, v, out))


@counted("flash_attention", _flash_cost)
def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: Optional[int] = None,
                           cap: Optional[float] = None,
                           scale: Optional[float] = None,
                           q_off: Optional[int] = None) -> torch.Tensor:
    """q [BH, Sq, D], k [BH, Sk, D], v [BH, Sk, Dv] -> [BH, Sq, Dv] in
    q.dtype (any Sq, Sk; D, Dv <= 256).  ``q_off`` anchors the causal /
    window mask: query row i sits at absolute position ``q_off + i``
    against keys at [0, Sk); default ``Sk - Sq`` (the queries are the key
    suffix).  A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes ``flash_attention_plain``."""
    bh, sq, d = q.shape
    sk, dv = v.shape[1], v.shape[2]
    if k.shape != (bh, sk, d) or v.shape[0] != bh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    scale = scale if scale is not None else d ** -0.5
    q_off = sk - sq if q_off is None else q_off
    kw = dict(causal=causal, window=window, cap=cap, scale=scale, q_off=q_off)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, **kw)
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention takes float32/bfloat16, got "
                         f"{q.dtype}")
    if d > _FLASH_MAX_D or dv > _FLASH_MAX_D:
        raise ValueError(f"flash_attention takes d, dv <= {_FLASH_MAX_D}, "
                         f"got {d}, {dv}")
    if bh > 65535:
        raise ValueError(f"flash_attention takes BH <= 65535, got {bh}")
    if cap is not None and cap <= 0:
        raise ValueError(f"softcap must be positive, got {cap}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    check_cuda_operand("q", q, q.device)
    check_cuda_operand("k", k, q.device, q.dtype)
    check_cuda_operand("v", v, q.device, q.dtype)
    out = torch.empty(bh, sq, dv, dtype=q.dtype, device=q.device)
    if out.numel():
        FLASH_KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            sk, d, dv, float(scale), int(causal),
            -1 if window is None else int(window),
            0.0 if cap is None else float(cap), int(q_off),
            DTYPE_CODES[q.dtype])
    return out


def flash_traffic(bh: int, sq: int, sk: int, d: int, dv: int, *,
                  dtype_bytes: int = 2,
                  block: Tuple[int, int] = DEFAULT_BLOCK_FA) -> dict:
    """The reference's traffic model of its flash kernel: q read once per
    kv sweep, k/v re-streamed per q block, scores never in device memory."""
    bq, bk = block
    q_bytes = bh * sq * d * dtype_bytes
    kv_bytes = (sq // bq) * bh * sk * (d + dv) * dtype_bytes
    out_bytes = bh * sq * dv * dtype_bytes
    flops = 2.0 * bh * sq * sk * (d + dv)
    return dict(hbm_bytes=q_bytes + kv_bytes + out_bytes, flops=flops,
                q_bytes=q_bytes, kv_bytes=kv_bytes, out_bytes=out_bytes)
