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

f32 (all three launchers, every N:M with M dividing 64) runs the
split-TF32 tensor-core body of ``csrc/nm_tf32.cuh``.  The f32 CUDA cores
(67 TFLOP/s) bound an FMA loop, and one TF32 pass misses the 1e-4 checks,
so each operand is split into hi + lo TF32 parts and three ``mma.sync``
passes (lo.hi, hi.lo, hi.hi) are summed in f32: f32-accurate MACs at up to
a third of the 495 TFLOP/s TF32 rate, over the dense MACs.  The compressed
operand is always the mma's A (W's rows in xwt, A's in spmm), the dense
one its B; a ``cp.async`` ring feeds values, indices and the dense tile,
and the warps decompress the next stage into a second shared A tile (the
reference's placement) between the current stage's mma.  Its plan
(``f32_plan``: warps, tile, ring and K splits) is a pure function of the
GEMM's shape and the SM count.

bf16 ``nm_xwt`` (int8 and packed) at N:M in ``FAST_NM`` runs the
tensor-core tile body of ``csrc/nm_mma.cuh``, shared with the onehot
decode body: the weight stream flows through a 2-4 stage ``cp.async`` ring,
W is decompressed in registers straight into ``mma.sync`` fragments, one
CTA covers every row of a call up to 128 (W read once), and K is split
across CTAs where the output tiles alone would leave the card empty.  The
launch plan (``mma_plan``: row and column tile, warps, ring, splits and K
per split) is a pure function of the shape and the SM count, computed here
and passed to the launcher with its shared-memory stage layout (``layout``:
row strides and stage bytes, which the launcher only checks).  The packed
instance stages its words with 16-byte copies and unpacks them from shared
memory.  ``nm_spmm`` in bf16 and bf16 ``nm_xwt`` at other N:M keep the
first body: one CTA per 64-wide output tile loops over K in 64-column
steps, decompressing into shared memory for ``mma.sync``.

Under both plans, split partial sums go to an f32 workspace allocated here
and are added in split order by a second kernel (no float atomics, so every
run gives the same bits), and the plan does not look at the index format,
so the packed instance equals the int8 one bit for bit.  Ragged edges are
masked in the kernels, never padded.

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
from repro_torch.launch.op_cost import counted, operand_bytes

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
# + twelve plan ints (bf16: the mma plan's eight, nt = 0 for the first
# body, and its stage layout's four; f32: the F32Plan's five and its
# shared memory, then zeros) and the split workspace
_PLAN_ARGS = _ARGS + [_I] * 12 + [_P]
KERNEL = CudaKernel("nm_xwt", "nm_xwt_launch", _PLAN_ARGS)
PACKED_KERNEL = CudaKernel("nm_xwt_packed", "nm_xwt_packed_launch",
                           _PLAN_ARGS, lib="nm_xwt")
SPMM_KERNEL = CudaKernel("nm_spmm", "nm_spmm_launch", _PLAN_ARGS,
                         lib="nm_xwt")
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
    stages: int   # ring depth: 3 or 4
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


SPLIT_WS_LIMIT = 256 << 20   # bytes of f32 split partials a plan may ask


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
    (or all the slots and K allow), then the fewest splits.  A split count
    whose f32 partial sums ([splits, rows, o]) pass ``SPLIT_WS_LIMIT`` is
    not taken: at prefill lengths of thousands of rows the tiles fill the
    card alone, and the waves' rounding would otherwise pick a hundred
    splits for a few percent of modelled time and gigabytes of partials
    (gemma2-9b's wd at 4096 rows: 112 splits, 6.1 GiB).  ``decode``
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
        if splits > 1 and splits * rows * o * 4 > SPLIT_WS_LIMIT:
            continue
        key = (-(-tiles * splits // slots) * per, tiles * splits < fill,
               splits)
        if best is None or key < best[0]:
            best = (key, splits, per)
    _, splits, per = best
    return full._replace(splits=splits, kper=64 * ss * per)


class F32Plan(NamedTuple):
    """Launch plan of the split-TF32 f32 body (``csrc/nm_tf32.cuh``) for
    out = W_sp . D^T with ``rows`` compressed rows and ``cols`` dense
    columns (xwt: rows = O, cols = S; spmm: rows = R, cols = C).  Every
    warp holds a 32 x 32 output tile."""
    wm: int       # warps along the compressed rows, 32 rows each
    wn: int       # warps along the dense columns, 32 columns each
    stages: int   # ring depth: 3 or 4
    splits: int   # CTAs along K
    kper: int     # K columns per split (a multiple of 64)

    @property
    def row_tile(self) -> int:
        return 32 * self.wm

    @property
    def col_tile(self) -> int:
        return 32 * self.wn

    @property
    def threads(self) -> int:
        return 32 * self.wm * self.wn

    def grid(self, rows: int, cols: int):
        return (-(-cols // self.col_tile), -(-rows // self.row_tile),
                self.splits)

    def ctas(self, rows: int, cols: int) -> int:
        gx, gy, gz = self.grid(rows, cols)
        return gx * gy * gz


# (wm, wn) by row tile, widest column tile first, at most 8 warps
F32_TILES = {128: ((4, 2), (4, 1)),
             64: ((2, 4), (2, 2), (2, 1)),
             32: ((1, 8), (1, 4), (1, 2), (1, 1))}
HALF_SM = 115712    # shared memory of each of two CTAs on one SM
# The plan's time model (seconds): a stage of an m x n tile costs its
# three-pass MACs at an assumed 300 TFLOP/s of mma.sync TF32 over 132 SMs
# plus a fixed 0.25 us (barriers, decompress, latency); K splits cost their
# partial sums' bytes at 3.35 TB/s and a 3 us reduce launch.
_SM_TF32 = 300e12 / SMS
_STAGE_FIXED = 0.25e-6
_HBM = 3.35e12


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def f32_stage_cols(m: int) -> int:
    """K columns per ring stage of the f32 body: 32, or 64 at M = 64 (one
    M-block per stage)."""
    return 64 if m > 32 else 32


def f32_smem_bytes(plan: F32Plan, n: int, m: int) -> int:
    """Dynamic shared memory of a CTA under ``plan`` (what the launcher's
    ``check_plan`` in ``csrc/nm_tf32.cuh`` derives, taking the larger of
    the int8 and the packed index rows and of the xwt [n][k] and the spmm
    [k][n] dense tile, so every launcher takes one plan): two f32 A tiles
    (the stage the mma reads and the next one being decompressed), then
    ``stages`` ring stages of values, indices and dense tile."""
    ks = f32_stage_cols(m)
    e = ks // m * n
    per_word = 32 // index_bits(m)
    istride = _r16(max(e, 4 * (-(-e // per_word) + 1)))
    bm, bn = plan.row_tile, plan.col_tile
    dense = max(bn * (ks + 4) * 4, ks * (bn + 8) * 4)
    stage = -(-(bm * (_r16(4 * e) + istride) + dense) // 128) * 128
    return 2 * bm * (ks + 4) * 4 + plan.stages * stage


def f32_row_tile(rows: int) -> int:
    """The row tile for ``rows`` compressed rows: the one of 128, 64, 32
    that pads the rows least, the largest on a tie."""
    return min((128, 64, 32), key=lambda t: (-(-rows // t) * t, -t))


def f32_cost(plan: F32Plan, rows: int, cols: int, n: int, m: int,
             sms: int) -> float:
    """The plan's modelled seconds: the stages on the busiest SM (CTAs
    spread evenly over the SMs; a stage's fixed part doubles where one CTA
    holds the SM alone) and the split partial sums' traffic."""
    ks = f32_stage_cols(m)
    alone = f32_smem_bytes(plan, n, m) > HALF_SM
    stage = 6.0 * ks * plan.row_tile * plan.col_tile / _SM_TF32 \
        + _STAGE_FIXED * (2 if alone else 1)
    t = -(-plan.ctas(rows, cols) // sms) * (plan.kper // ks) * stage
    if plan.splits > 1:
        t += 2.0 * plan.splits * rows * cols * 4 / _HBM + 3e-6
    return t


def _f32_ring(wm: int, wn: int, n: int, m: int) -> Optional[F32Plan]:
    """The tile with the deepest ring (4 or 3 stages: the body decompresses
    stage st + 1 while stage st feeds the mma) under which two CTAs share
    an SM, else with 3 stages if one CTA fits, else None."""
    for stages in (4, 3):
        plan = F32Plan(wm, wn, stages, 1, 64)
        if f32_smem_bytes(plan, n, m) <= HALF_SM:
            return plan
    return plan if f32_smem_bytes(plan, n, m) <= SMEM_LIMIT else None


# K columns one CTA of the split-TF32 body accumulates.  The tensor cores
# add each mma's products into the f32 accumulator with a drift that grows
# with the chain: against the exact f32 product, four f32 gemma2-9b layers
# (logits of magnitude ~19) moved by 2.9e-3 with all of K 14336 in one
# CTA and by 1.03e-3 with at most 1024 columns (chip runs on an H100);
# longer K is split, and the reduce kernel adds the splits' partials in
# IEEE f32.
F32_MAX_KPER = 512


@functools.lru_cache(maxsize=4096)
def f32_plan(rows: int, cols: int, k: int, n: int, m: int,
             sms: int = SMS) -> Optional[F32Plan]:
    """The split-TF32 body's plan for out = W_sp[rows, k] . D[cols, k]^T,
    or None for an empty output or an N:M the body does not take.  A pure
    function of the shape and the SM count, not of the index format or the
    orientation.  The row tile pads the rows least (``f32_row_tile``;
    a smaller one where no tile of it fits the shared memory); the column
    tile and the K splits (whole 64-column steps, at most
    ``F32_MAX_KPER`` columns each) are the ones with the least
    ``f32_cost`` among those that put at least 0.9 x min(SMs, the most
    CTAs the shape allows) CTAs on the card, on a tie the fewer splits,
    then the wider tile; the ring is the deepest that lets two CTAs share
    an SM (``_f32_ring``)."""
    if min(rows, cols, k) <= 0 or k % m or BK % m or not 0 < n < m:
        return None
    nst = -(-k // BK)
    plans = []
    for bm in (128, 64, 32):     # the least padded first, then smaller
        if bm > f32_row_tile(rows):
            continue
        for wm, wn in F32_TILES[bm]:
            ring = _f32_ring(wm, wn, n, m)
            if ring is None:
                continue
            for s in range(1, nst + 1):
                per = -(-nst // s)
                if BK * per > F32_MAX_KPER:
                    continue
                plans.append(ring._replace(splits=-(-nst // per),
                                           kper=BK * per))
        if plans:
            break
    most = max(p.ctas(rows, cols) for p in plans)
    fill = 0.9 * min(sms, most)
    return min((p for p in plans if p.ctas(rows, cols) >= fill),
               key=lambda p: (f32_cost(p, rows, cols, n, m, sms), p.splits,
                              -p.col_tile))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_args(plan, rows: int, o: int, n: int, m: int, packed: bool,
              device: torch.device):
    """The launcher's twelve plan ints and workspace pointer, and the f32
    split workspace [splits, rows, O] of the output itself (None without
    splits), which the caller keeps alive until the launch is queued.  An
    ``MmaPlan`` gives its eight ints and its stage layout's four, an
    ``F32Plan`` its five and its shared memory, then zeros; None (the first
    bf16 body) gives zeros."""
    if plan is None:
        return NO_PLAN + (None,), None
    ws = None
    if plan.splits > 1:
        ws = torch.empty(plan.splits, rows, o, dtype=torch.float32,
                         device=device)
    if isinstance(plan, F32Plan):
        ints = tuple(plan) + (f32_smem_bytes(plan, n, m),) + (0,) * 6
    else:
        ints = tuple(plan) + layout(plan, n, m, packed)
    return ints + (ws.data_ptr() if ws is not None else None,), ws


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
           n: int, m: int, plan_o: Optional[int] = None) -> torch.Tensor:
    """Y = X @ W_sp.T for X [..., K] of any leading shape; W compressed
    [O, K/M*N], int8 indices.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes ``nm_xwt_plain``.  ``plan_o`` is the whole
    weight's O when W is a shard of its rows: the launch takes the whole
    shape's plan (its K splits), so each output sums in the same order."""
    return _xwt(KERNEL, nm_xwt_plain, x, values, indices, n, m, torch.int8,
                plan_o)


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


def _xwt(kernel: CudaKernel, plain, x, values, idx, n, m, idx_dtype,
         plan_o=None):
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
    return launch_xwt(kernel, xf, values, idx, n, m,
                      plan_o).reshape(*lead, o)


def launch_xwt(kernel: CudaKernel, x: torch.Tensor, values: torch.Tensor,
               idx: torch.Tensor, n: int, m: int,
               plan_o: Optional[int] = None) -> torch.Tensor:
    """The int8 or packed launch on checked operands x [rows, K]: f32
    under ``f32_plan`` (O compressed rows, ``rows`` dense columns), bf16
    under ``mma_plan`` (None outside ``FAST_NM``: the first body).  Neither
    plan looks at the index stream, so both instances take one plan.  A
    shard of ``plan_o`` rows takes the whole shape's plan: the tiles are
    cut from the shard's own O, the K splits are the whole's."""
    rows, k = x.shape
    o = values.shape[0]
    plan = None
    if rows and o:
        sms = sm_count(x.device)
        po = plan_o or o
        plan = f32_plan(po, rows, k, n, m, sms) if x.dtype == torch.float32 \
            else mma_plan(rows, po, k, n, m, sms)
    return launch_planned(kernel, x, values, idx, n, m, plan)


def launch_planned(kernel: CudaKernel, x: torch.Tensor, values: torch.Tensor,
                   idx: torch.Tensor, n: int, m: int, plan) -> torch.Tensor:
    """One launch of ``kernel`` (an ``nm_xwt`` launcher or the onehot
    ``nm_spmv`` one) on checked card operands x [rows, K] under ``plan``
    (an ``MmaPlan``, an ``F32Plan``, or None: the first bf16 body); returns
    y [rows, O]."""
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


def _nm_spmm_cost(c, values, indices, b, *args, **kwargs):
    """Dense-equivalent 2 * R * K * C, each operand once."""
    return (2.0 * c.numel() * b.shape[0],
            operand_bytes(values, indices, b, c))


@counted("nm_spmm", _nm_spmm_cost)
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
        plan = f32_plan(r, c, k, n, m, sm_count(b.device)) \
            if b.dtype == torch.float32 else None
        args, _ws = plan_args(plan, r, c, n, m, False, b.device)
        SPMM_KERNEL.launch(values.data_ptr(), indices.data_ptr(),
                           b.data_ptr(), out.data_ptr(), r, c, k, n, m,
                           DTYPE_CODES[b.dtype], *args)
    return out
