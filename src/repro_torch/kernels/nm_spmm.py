"""The tiled N:M sparse-dense products, both orientations of the reference's
``repro/kernels/nm_spmm.py``:

  nm_xwt         Y[S, O] = X[S, K] . W_sp^T (layer orientation), W's
                 indices int8
  nm_xwt_packed  the same, W's indices as the paper's bit-packed words
  nm_spmm        C[R, C] = A_sp[R, K] . B[K, C] (the paper's orientation)

Kernel: ``csrc/nm_xwt.cu`` (CUDA C++, sm_90a).  It replaces the TPU
kernels ``repro/kernels/nm_spmm.py::nm_xwt_kernel`` (``_xwt_body`` +
``_decompress_tile``; ``packed=True`` adds ``_unpack_indices_tile``) and
``::nm_spmm_kernel`` (``_spmm_body``), wrappers ``repro/kernels/ops.py``.
At serving prefill lengths the compressed weight bytes bound it on the
H100; at the CNN GEMMs' widths the operations.

bf16 ``nm_xwt`` (int8 and packed) at N:M in ``FAST_NM`` runs the
tensor-core tile body of ``csrc/nm_mma.cuh``, shared with the onehot
decode body: the weight stream flows through a 2-4 stage ``cp.async`` ring,
W is decompressed in registers straight into ``mma.sync`` fragments, one
CTA covers every row of a call up to 128 (W read once), and K is split
across CTAs where the output tiles alone would leave the card empty.  The
launch plan (``mma_plan``: row and column tile, warps, ring, splits and K
per split) is a pure function of the shape and the SM count, computed here
and passed to the launcher with its shared-memory stage layout (``layout``:
row strides and stage bytes, which the launcher only checks); split partial sums go to an f32 workspace
allocated here and are added in split order by a second kernel (no float
atomics, so every run and both index formats give the same bits).  The
packed instance stages its words with 16-byte copies and unpacks them from
shared memory; it takes the int8 plan, so its output equals the int8
kernel's bit for bit.  f32 (all three launchers), ``nm_spmm`` in bf16 and
bf16 at other N:M keep the first body: one CTA per 64-wide output tile
loops over K in 64-column steps, decompressing into shared memory
(``mma.sync`` in bf16, an f32 FMA loop in f32).  Ragged edges are masked
in the kernel, never padded.

``nm_xwt_plain``, ``nm_xwt_packed_plain`` and ``nm_spmm_plain`` are the same
functions in plain torch: the CPU path, and what the kernels are held
against on the card.  Each launcher has its own launch counter (``KERNEL``,
``PACKED_KERNEL``, ``SPMM_KERNEL``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.sparsity import (decompress_parts, index_bits,
                                       unpack_indices)
from repro_torch.kernels.ref import nm_spmm_ref
from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel,
                                       check_cuda_operand)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
# + the plan's eight ints (nt = 0: the first body), its stage layout's four
# and the split workspace
_PLAN_ARGS = _ARGS + [_I] * 12 + [_P]
KERNEL = CudaKernel("nm_xwt", "nm_xwt_launch", _PLAN_ARGS)
PACKED_KERNEL = CudaKernel("nm_xwt_packed", "nm_xwt_packed_launch",
                           _PLAN_ARGS, lib="nm_xwt")
SPMM_KERNEL = CudaKernel("nm_spmm", "nm_spmm_launch", _ARGS, lib="nm_xwt")
BK = 64     # the kernels' K step: M must divide it
SMS = 132   # streaming multiprocessors of an H100 SXM
# the (N, M) the tensor-core body is instantiated for (M divides 16, N <= 2)
FAST_NM = ((1, 2), (1, 4), (2, 4), (2, 8))


NO_PLAN = (0,) * 12  # the launchers' plan and layout ints: the first body


class MmaPlan(NamedTuple):
    """Launch plan of the tensor-core tile body (``csrc/nm_mma.cuh``)."""
    nt: int       # 8-row n-tiles per warp (1, 4 or 8)
    ws: int       # warps along the rows (1, 2 or 4)
    wo: int       # warps along O, 32 output columns each
    wk: int       # warps sharing each stage's 64-column supersteps
    ss: int       # supersteps per ring stage
    stages: int   # ring depth
    splits: int   # CTAs along K
    kper: int     # K columns per split (a multiple of 64)

    @property
    def row_tile(self) -> int:
        return 8 * self.nt * self.ws

    @property
    def col_tile(self) -> int:
        return 32 * self.wo

    @property
    def threads(self) -> int:
        return 32 * self.wo * self.ws * self.wk

    def grid(self, rows: int, o: int):
        return (-(-o // self.col_tile), -(-rows // self.row_tile), self.splits)

    def ctas(self, rows: int, o: int) -> int:
        gx, gy, gz = self.grid(rows, o)
        return gx * gy * gz


# Tile by rows of the call: (nt, ws, wk, ss, stages, wo from the widest).
# Decode (the onehot body: n = 8 batch rows) takes 32-64 output columns
# per CTA and four warps per column tile sharing 256-column stages;
# prefill takes every row (up to 128) in one CTA, two 64-row warps per
# column tile above 64 rows.  Chosen by device-time trials of one llama
# layer on the H100: rings of two or three stages were as fast as deeper
# ones and leave room for more CTAs per SM.
ROW_CLASSES = (
    (8, (1, 1, 4, 4, 3, (2, 1))),
    (32, (4, 1, 2, 2, 2, (4, 2, 1))),
    (64, (8, 1, 2, 2, 2, (2, 1))),
    (None, (8, 2, 1, 2, 2, (4, 2))),
)


def row_class(rows: int, decode: bool = False):
    """The ``ROW_CLASSES`` entry for a call of ``rows`` rows."""
    for limit, cls in ROW_CLASSES:
        if decode or limit is None or rows <= limit:
            return cls


SMEM_LIMIT = 232448    # dynamic shared memory a CTA may take on sm_90


def _pad_stride(nbytes: int, phase: int) -> int:
    r = -(-nbytes // 16) * 16
    return r + (phase - r % 128) % 128


def layout(plan: MmaPlan, n: int, m: int, packed: bool):
    """The byte layout of one ring stage under ``plan``: the row strides of
    its values, index (int8 bytes or packed words) and X tiles, and the
    stage's bytes.  Each stride is rounded up to 16 bytes, then to a phase
    modulo 128 at which the 8 rows that one 16-byte shared-memory phase
    reads fall on distinct banks.  The launcher takes it as it is and only
    checks that the tiles fit (``check_layout`` in ``csrc/nm_mma.cuh``)."""
    kc = 64 * plan.ss
    e = kc // m * n                         # slots per staged row
    p16 = 16 * n // m                       # slots per 16 columns
    vstride = _pad_stride(2 * e, 8 * p16)
    if packed:   # the words of e slots from a 16-byte boundary, plus slack
        istride = _pad_stride(4 * (-(-e // (32 // index_bits(m))) + 8), 16)
    else:
        istride = _pad_stride(e, 4 * p16)
    xstride = _pad_stride(2 * kc, 16)
    stage = plan.col_tile * (vstride + istride) + plan.row_tile * xstride
    return vstride, istride, xstride, -(-stage // 128) * 128


def smem_bytes(plan: MmaPlan, n: int, m: int) -> int:
    """Dynamic shared memory of a CTA under ``plan``: its ring (the larger
    of the int8 and the packed stage, so both instances can take one plan)
    or the ``wk`` warps' reduction buffer, whichever is larger."""
    stage = max(layout(plan, n, m, packed)[3] for packed in (False, True))
    red = (plan.wk - 1) * plan.wo * plan.ws * 8 * plan.nt * 32 * 4
    slots = min(plan.stages, -(-plan.kper // (64 * plan.ss)))
    return max(slots * stage, red)


def fits(plan: MmaPlan, n: int, m: int) -> bool:
    """Whether one CTA of ``plan`` fits the kernels' launch bound (256
    threads) and the shared memory of an SM."""
    return plan.threads <= 256 and smem_bytes(plan, n, m) <= SMEM_LIMIT


def resident(plan: MmaPlan, n: int, m: int) -> int:
    """CTAs of ``plan`` one SM holds at once, by shared memory and threads
    (registers allowing)."""
    return min(SMEM_LIMIT // smem_bytes(plan, n, m), 2048 // plan.threads, 32)


@functools.lru_cache(maxsize=4096)
def mma_plan(rows: int, o: int, k: int, n: int, m: int, sms: int = SMS,
             decode: bool = False) -> Optional[MmaPlan]:
    """The tensor-core body's plan for out[rows, o] = X[rows, k] . W^T, or
    None where it does not apply (N:M outside ``FAST_NM``).  A pure function
    of the shape and the SM count.  The column tile is the widest of the
    row class whose tiles, split along K into single ring stages, could
    fill every SM's resident CTAs once; K is then split into the number of
    splits s that minimises waves(s) x stages per CTA(s), waves being the
    CTAs over the card's resident slots (counted for the full ring)
    rounded up; on a tie, one that puts about 2 CTAs per SM on the card
    (or all the slots and K allow), then the fewest splits.  ``decode``
    forces the 8-row tile (the onehot body)."""
    if (n, m) not in FAST_NM or min(rows, o, k) <= 0 or k % m:
        return None
    nt, ws, wk, ss, stages, wos = row_class(rows, decode)
    nst = -(-k // (64 * ss))              # ring stages over all of K
    row_tiles = -(-rows // (8 * nt * ws))
    choice = None
    for wo in wos:
        full = MmaPlan(nt, ws, wo, wk, ss, stages, 1, 64 * ss * nst)
        if not fits(full, n, m):
            continue
        slots = sms * resident(full, n, m)
        tiles = -(-o // (32 * wo)) * row_tiles
        choice = (full, slots, tiles)
        if tiles * nst >= slots:
            break
    if choice is None:
        return None
    full, slots, tiles = choice
    fill = 0.9 * min(2 * sms, slots, tiles * nst)   # about 2 CTAs per SM
    best = None
    for s in range(1, nst + 1):
        per = -(-nst // s)                # stages per split
        splits = -(-nst // per)
        key = (-(-tiles * splits // slots) * per, tiles * splits < fill,
               splits)
        if best is None or key < best[0]:
            best = (key, splits, per)
    _, splits, per = best
    return full._replace(splits=splits, kper=64 * ss * per)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_args(plan: Optional[MmaPlan], rows: int, o: int, n: int, m: int,
              packed: bool, device: torch.device):
    """The launcher's plan and layout ints and workspace pointer, and the
    f32 split workspace [splits, rows, O] itself (None without splits),
    which the caller keeps alive until the launch is queued."""
    if plan is None:
        return NO_PLAN + (None,), None
    ws = None
    if plan.splits > 1:
        ws = torch.empty(plan.splits, rows, o, dtype=torch.float32,
                         device=device)
    return (tuple(plan) + layout(plan, n, m, packed)
            + (ws.data_ptr() if ws is not None else None,)), ws


def nm_xwt_plain(x: torch.Tensor, values: torch.Tensor,
                 indices: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """x [S, K] -> [S, O] in x.dtype: decompress W to f32 (the kernel's
    tile decompress), then an f32 product."""
    w = decompress_parts(values, indices, n, m, x.shape[-1],
                         dtype=torch.float32)
    return (x.float() @ w.t()).to(x.dtype)


def nm_xwt_packed_plain(x: torch.Tensor, values: torch.Tensor,
                        words: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """``nm_xwt_plain`` with W's indices given as packed words [O,
    ceil(nnz / per_word)] (uint32 or int32 bit patterns): unpacked, then the
    same decompress and product."""
    return nm_xwt_plain(x, values,
                        unpack_indices(words, m, values.shape[-1]), n, m)


# A_sp [R, nnz] . b [K, C] -> [R, C] in b.dtype: decompress A, then an f32
# product; the oracle is already that function
nm_spmm_plain = nm_spmm_ref


def _check(k: int, values: torch.Tensor, n: int, m: int) -> None:
    if values.shape[-1] != k // m * n or k % m:
        raise ValueError(f"values {tuple(values.shape)} do not match K={k} "
                         f"at {n}:{m}")


def _check_kernel(name: str, dtype: torch.dtype, n: int, m: int) -> None:
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name} kernel takes float32/bfloat16, got {dtype}")
    if not 0 < n < m or BK % m:
        raise ValueError(f"{name} kernel needs 0 < n < m with m dividing "
                         f"{BK}, got {n}:{m}")


def nm_xwt(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
           n: int, m: int) -> torch.Tensor:
    """Y = X @ W_sp.T for X [..., K] of any leading shape; W compressed
    [O, K/M*N], int8 indices.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes ``nm_xwt_plain``."""
    return _xwt(KERNEL, nm_xwt_plain, x, values, indices, n, m, torch.int8)


def nm_xwt_packed(x: torch.Tensor, values: torch.Tensor, words: torch.Tensor,
                  n: int, m: int) -> torch.Tensor:
    """``nm_xwt`` with W's indices as packed words: [O, ceil(nnz /
    per_word)], each row's words in order (``pack_indices_i32`` of the int8
    indices; int32 bit patterns on the card).  A CUDA tensor launches the
    packed kernel (or raises); a CPU tensor takes ``nm_xwt_packed_plain``."""
    per_word = 32 // index_bits(m)
    want = (values.shape[0], -(-values.shape[-1] // per_word))
    if tuple(words.shape) != want:
        raise ValueError(f"packed words {tuple(words.shape)}, expected "
                         f"{want} for values {tuple(values.shape)} at M={m}")
    return _xwt(PACKED_KERNEL, nm_xwt_packed_plain, x, values, words, n, m,
                torch.int32)


def _xwt(kernel: CudaKernel, plain, x, values, idx, n, m, idx_dtype):
    lead, k = x.shape[:-1], x.shape[-1]
    o = values.shape[0]
    _check(k, values, n, m)
    xf = x.reshape(-1, k)
    if not x.is_cuda:
        return plain(xf, values, idx, n, m).reshape(*lead, o)
    _check_kernel(kernel.name, x.dtype, n, m)
    check_cuda_operand("x", xf, x.device)
    check_cuda_operand("values", values, x.device, x.dtype)
    check_cuda_operand("indices", idx, x.device, idx_dtype)
    return launch_xwt(kernel, xf, values, idx, n, m).reshape(*lead, o)


def launch_xwt(kernel: CudaKernel, x: torch.Tensor, values: torch.Tensor,
               idx: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """The int8 or packed launch on checked operands x [rows, K]: bf16
    under ``mma_plan`` (which does not look at the index stream, so both
    instances take one plan), f32 through the first body."""
    rows, k = x.shape
    o = values.shape[0]
    plan = mma_plan(rows, o, k, n, m, sm_count(x.device)) \
        if x.dtype == torch.bfloat16 and rows and o else None
    return launch_planned(kernel, x, values, idx, n, m, plan)


def launch_planned(kernel: CudaKernel, x: torch.Tensor, values: torch.Tensor,
                   idx: torch.Tensor, n: int, m: int,
                   plan: Optional[MmaPlan]) -> torch.Tensor:
    """One launch of ``kernel`` (an ``nm_xwt`` launcher or the onehot
    ``nm_spmv`` one) on checked card operands x [rows, K] under ``plan``
    (None: the first body); returns y [rows, O]."""
    rows, k = x.shape
    o = values.shape[0]
    y = torch.empty(rows, o, dtype=x.dtype, device=x.device)
    if rows and o:
        args, _ws = plan_args(plan, rows, o, n, m, kernel is PACKED_KERNEL,
                              x.device)
        kernel.launch(x.data_ptr(), values.data_ptr(), idx.data_ptr(),
                      y.data_ptr(), rows, o, k, n, m, DTYPE_CODES[x.dtype],
                      *args)
    return y


def nm_spmm(values: torch.Tensor, indices: torch.Tensor, b: torch.Tensor,
            n: int, m: int) -> torch.Tensor:
    """C = A_sp @ B, the paper's orientation: A compressed [R, K/M*N] with
    int8 indices, b [K, C] -> [R, C] in b.dtype (f32 accumulation).  A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes
    ``nm_spmm_plain``."""
    if b.dim() != 2:
        raise ValueError(f"b must be [K, C], got {tuple(b.shape)}")
    k, c = b.shape
    r = values.shape[0]
    _check(k, values, n, m)
    if not b.is_cuda:
        return nm_spmm_plain(values, indices, b, n, m)
    _check_kernel("nm_spmm", b.dtype, n, m)
    check_cuda_operand("b", b, b.device)
    check_cuda_operand("values", values, b.device, b.dtype)
    check_cuda_operand("indices", indices, b.device, torch.int8)
    out = torch.empty(r, c, dtype=b.dtype, device=b.device)
    if r and c:
        SPMM_KERNEL.launch(values.data_ptr(), indices.data_ptr(),
                           b.data_ptr(), out.data_ptr(), r, c, k, n, m,
                           DTYPE_CODES[b.dtype])
    return out
