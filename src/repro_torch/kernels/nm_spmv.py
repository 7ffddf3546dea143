"""Decode-shaped N:M sparse linear: Y[B, O] = X[B, K] . W_sp^T.

Kernel: ``csrc/nm_spmv.cu`` (CUDA C++, sm_90a).  It replaces the TPU kernel
``repro/kernels/nm_spmv.py::nm_spmv_kernel`` (gather body, wrapper
``repro/kernels/ops.py::nm_spmv``).  On the H100 it is bound by device-memory
bytes: each compressed weight row (values + int8 indices) is read once per
call, and only the N/M nonzero MACs are done.  The design is the paper's
``vindexmac`` on this card: x is resident in shared memory once per CTA,
batch-interleaved (``xs[k][b]`` for a group of up to 8 batch rows), so one
indexed read at ``block*M + idx`` returns that column for every batch row
(16 bytes in bf16), multiply-accumulated against one weight value.  A warp
streams 4 rows together, a row's step one 128-byte line of values, and the
lanes of a shared-memory phase read two M-blocks on opposite bank halves
(no bank conflicts at M <= 4); CTAs are persistent over row groups, kw
warps share a row group's K parts (summed in shared memory in warp
order), and K is split across CTAs where the rows alone cannot fill the
card; the last CTA of a row set adds the splits' f32 partial sums in split
order (an int arrival counter per set: the same bits on every launch, no
float atomics).  The launch plan (``gather_plan``: batch group, kw, CTAs,
splits, columns per split) is a pure function of the shape and the SM
count, computed here; the launcher only checks it.  Any batch B >= 1 is
taken as it is (no pad-to-8); batches above 8 take more CTAs.

``mode="onehot"`` runs the reference's other body (``nm_spmv.py:43-47``):
decompress each W tile, then a dense dot.  Its kernel
(``nm_spmv_onehot_launch`` in the same file) is bound by the same bytes.
In bf16 at N:M in ``nm_spmm.FAST_NM`` it runs the tensor-core tile body of
``csrc/nm_mma.cuh`` (shared with ``nm_xwt``) with the batch on n = 8: a
``cp.async`` ring of 256-column stages of the weight stream, W
decompressed in registers into ``mma.sync`` fragments, four warps per CTA
sharing each stage, and K split across CTAs so that every decode shape
fills the card; the plan (``nm_spmm.mma_plan(..., decode=True)``) is
computed here, the split workspace allocated here, and the partial sums
are added in a fixed order (no float atomics: the same bits on every run).
f32, and bf16 at other N:M, keep the first body: each [32, 64] W tile
decompressed into f32 shared memory beside the staged x tile, one f32 FMA
dot per (row, batch) thread.  It has its own launch counter
(``ONEHOT_KERNEL``), so a run can prove which body served it.

``nm_spmv_plain`` and ``nm_spmv_onehot_plain`` are the same functions in
plain torch: the CPU path, and what the kernels are held against on the
card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel,
                                       check_cuda_operand)
from repro_torch.kernels.nm_spmm import (_PLAN_ARGS, BK, SMEM_LIMIT, SMS,
                                         launch_planned, mma_plan,
                                         nm_xwt_plain, sm_count)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
# + the gather plan's five ints, the split workspace and the arrival counters
KERNEL = CudaKernel("nm_spmv", "nm_spmv_launch", _ARGS + [_I] * 5 + [_P, _P])
ONEHOT_KERNEL = CudaKernel("nm_spmv_onehot", "nm_spmv_onehot_launch",
                           _PLAN_ARGS, lib="nm_spmv")
MODES = ("gather", "onehot")

GATHER_WARPS = 8      # warps per CTA of the gather body
GATHER_ROWS = 4       # rows a warp streams together (a row group)
GATHER_STEP = 64      # slots of each row a warp streams per step
GATHER_CPS = 2        # CTAs an SM holds at once (256 threads, <= 128 registers)
SM_SMEM = 233472      # shared memory of one SM (1 KB of it per CTA reserved)
GATHER_STATIC = 2048  # a CTA's static shared memory (the K parts' sums)
MAX_SPLITS = 32


class GatherPlan(NamedTuple):
    """Launch plan of the gather body (``csrc/nm_spmv.cu``)."""
    bg: int       # batch rows per group (1, 2, 4 or 8): x's column width
    kw: int       # warps sharing a row group, each a K part (1, 2, 4, 8)
    ctas: int     # CTAs per (split, batch group), persistent over rows
    splits: int   # CTAs along K
    kper: int     # K columns per split

    def groups(self, b: int) -> int:
        return -(-b // self.bg)

    def grid(self, b: int):
        return (self.ctas, self.splits, self.groups(b))

    def total(self, b: int) -> int:
        return self.ctas * self.splits * self.groups(b)

    def pass_rows(self) -> int:
        """Rows a CTA takes at once: its row groups of 4."""
        return GATHER_WARPS // self.kw * GATHER_ROWS

    def smem(self, elt: int) -> int:
        """Dynamic shared memory of a CTA: the resident x slice."""
        return self.kper * self.bg * elt

    def for_rows(self, o: int) -> "GatherPlan":
        """This plan over ``o`` rows: a shard of the rows it was made for
        keeps its K splits and warps per row group (so each row sums in the
        same order) and takes no more CTAs than its row groups fill."""
        return self._replace(ctas=min(self.ctas, -(-o // self.pass_rows())))


def gather_unit(n: int, m: int) -> int:
    """The K columns a split boundary is a multiple of: whole M-blocks,
    whole 8-column (16-byte) x runs, and whole 8-slot value loads."""
    u = m * 8 // math.gcd(n, 8)
    return u * 8 // math.gcd(u, 8)


@functools.lru_cache(maxsize=4096)
def gather_plan(b: int, o: int, k: int, n: int, m: int, elt: int = 2,
                sms: int = SMS) -> GatherPlan:
    """The gather body's plan for Y[b, o] = X[b, k] . W^T at ``elt`` bytes
    per element: a pure function of the shape and the SM count.  The
    batch group is the smallest power of two covering min(b, 8).  Each
    split count s (x's slice within a CTA's shared memory), number kw of
    warps sharing a row group and number of passes over row groups per
    CTA is costed as CTAs per SM x (passes x (64-slot steps per warp + a
    row group's reduction) + the x stage), over the share of 16 warps an
    SM holds at once (fewer leave the weight stream's latency exposed),
    plus a split's fix-up; the plan that fills every SM (where any can) at
    the least cost, then with the fewest splits, kw and passes, is
    taken."""
    bg = 1
    while bg < min(b, 8):
        bg *= 2
    groups = -(-b // bg)
    rgroups = -(-o // GATHER_ROWS)
    unit = gather_unit(n, m)
    units = -(-k // unit)
    best = None
    for s in range(1, min(units, MAX_SPLITS) + 1):
        per = -(-units // s)
        if -(-units // per) != s:
            continue
        kper = per * unit
        smem = kper * bg * elt
        if smem > SMEM_LIMIT:
            continue
        es = min(kper, k) // m * n
        resident = min(GATHER_CPS, SM_SMEM // (smem + GATHER_STATIC + 1024))
        for kw in (1, 2, 4, 8):
            per_pass = GATHER_WARPS // kw
            steps = -(-es // (kw * GATHER_STEP))
            last = None
            for passes in range(1, 129):
                ctas = -(-rgroups // (per_pass * passes))
                if ctas == last:
                    continue
                last = ctas
                total = ctas * s * groups
                per_sm = -(-total // sms)
                warps = GATHER_WARPS * min(per_sm, resident)
                work = passes * (steps + (0.3 if kw > 1 else 0.1)) \
                    + 0.5 + 0.5 * kper / 2048
                cost = per_sm * work / min(1.0, warps / 16) \
                    + (2.0 + 0.1 * s if s > 1 else 0.0)
                key = (total < sms, cost, s, kw, passes)
                if best is None or key < best[0]:
                    best = (key, GatherPlan(bg, kw, ctas, s, kper))
    if best is None:
        raise ValueError(f"nm_spmv: no gather plan fits K={k} at {n}:{m} "
                         f"in {SMEM_LIMIT} B of shared memory")
    return best[1]


_ARRIVALS = {}        # device -> int32 arrival counters, zero between launches
_OUTGROWN = []        # counters a larger set replaced: a CUDA graph may name them


def _arrivals(device: torch.device, count: int) -> torch.Tensor:
    """At least ``count`` arrival counters on ``device``, zero between
    launches (each kernel resets its own).  Grown outside a CUDA graph
    capture only: a capture raises if it would need more than the warm-up
    allocated, and a replaced set stays allocated, since a captured graph
    keeps its address."""
    cnt = _ARRIVALS.get(device)
    if cnt is None or cnt.numel() < count:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"split-K arrival counters would grow to {count} inside a "
                f"CUDA graph capture; run the shape eagerly first")
        if cnt is not None:
            _OUTGROWN.append(cnt)
        cnt = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
        _ARRIVALS[device] = cnt
    return cnt


def launch_gather(x: torch.Tensor, values: torch.Tensor,
                  indices: torch.Tensor, n: int, m: int,
                  plan: GatherPlan) -> torch.Tensor:
    """One launch of the gather body on checked card operands x [B, K]
    under ``plan``; returns y [B, O]."""
    bsz, k = x.shape
    o = values.shape[0]
    y = torch.empty(bsz, o, dtype=x.dtype, device=x.device)
    if bsz and o:
        ws = cnt = None
        if plan.splits > 1:
            ws = torch.empty(plan.splits, bsz, o, dtype=torch.float32,
                             device=x.device)
            cnt = _arrivals(x.device, plan.ctas * plan.groups(bsz))
        KERNEL.launch(x.data_ptr(), values.data_ptr(), indices.data_ptr(),
                      y.data_ptr(), bsz, o, k, n, m, DTYPE_CODES[x.dtype],
                      *plan, None if ws is None else ws.data_ptr(),
                      None if cnt is None else cnt.data_ptr())
    return y


def nm_spmv_plain(x: torch.Tensor, values: torch.Tensor,
                  indices: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """x [B, K] -> [B, O] in x.dtype; f32 gather-MAC, one in-block slot at a
    time (bounds the [B, O, K/M] temporaries)."""
    o, nnz = values.shape
    nb = nnz // n
    base = (torch.arange(nb, device=x.device) * m).unsqueeze(0)   # [1, nb]
    xf = x.float()
    vals3 = values.reshape(o, nb, n).float()
    idx3 = indices.reshape(o, nb, n).long()
    acc = torch.zeros(x.shape[0], o, dtype=torch.float32, device=x.device)
    for s in range(n):
        g = xf[:, base + idx3[:, :, s]]                              # [B, o, nb]
        acc += torch.einsum("bon,on->bo", g, vals3[:, :, s])
    return acc.to(x.dtype)


# x [B, K] -> [B, O] in x.dtype, the onehot body: decompress W to f32, then
# a dense f32 dot, which is the tile path's plain version
nm_spmv_onehot_plain = nm_xwt_plain


def nm_spmv(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
            n: int, m: int, mode: str = "gather",
            plan_o: int | None = None) -> torch.Tensor:
    """Y = X @ W_sp.T for a decode-shaped X [..., K]; W compressed
    [O, K/M*N].  ``mode`` picks the body: ``"gather"`` (N/M of the MACs,
    indexed reads of x) or ``"onehot"`` (decompress, dense dot).  A CUDA
    tensor launches that body's kernel (or raises); a CPU tensor takes
    ``nm_spmv_plain`` / ``nm_spmv_onehot_plain``.  ``plan_o`` is the whole
    weight's O when W is a shard of its rows (tensor-parallel serving): the
    launch takes the whole shape's plan, so every row sums in the order
    the whole launch sums it."""
    if mode not in MODES:
        raise ValueError(f"unknown spmv mode {mode!r} (one of {MODES})")
    onehot = mode == "onehot"
    lead, k = x.shape[:-1], x.shape[-1]
    o, nnz = values.shape
    if nnz != k // m * n or k % m:
        raise ValueError(f"values {tuple(values.shape)} do not match K={k} "
                         f"at {n}:{m}")
    xf = x.reshape(-1, k)
    if not x.is_cuda:
        plain = nm_spmv_onehot_plain if onehot else nm_spmv_plain
        return plain(xf, values, indices, n, m).reshape(*lead, o)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"nm_spmv kernel takes float32/bfloat16, got {x.dtype}")
    if not 0 < n < m <= 127:
        raise ValueError(f"nm_spmv kernel needs 0 < n < m <= 127, got {n}:{m}")
    if onehot and BK % m:      # the onehot body steps K by the tile's BK
        raise ValueError(f"nm_spmv onehot kernel needs m dividing "
                         f"{BK}, got {n}:{m}")
    check_cuda_operand("x", xf, x.device)
    check_cuda_operand("values", values, x.device, x.dtype)
    check_cuda_operand("indices", indices, x.device, torch.int8)
    bsz = xf.shape[0]
    if onehot:
        plan = mma_plan(bsz, plan_o or o, k, n, m, sm_count(x.device),
                        decode=True) \
            if x.dtype == torch.bfloat16 and bsz and o else None
        y = launch_planned(ONEHOT_KERNEL, xf, values, indices, n, m, plan)
        return y.reshape(*lead, o)
    if not bsz or not o:
        return torch.empty(*lead, o, dtype=x.dtype, device=x.device)
    plan = gather_plan(bsz, plan_o or o, k, n, m, x.element_size(),
                       sm_count(x.device)).for_rows(o)
    return launch_gather(xf, values, indices, n, m, plan).reshape(*lead, o)
