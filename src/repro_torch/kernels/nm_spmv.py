"""Decode-shaped N:M sparse linear: Y[B, O] = X[B, K] . W_sp^T.

Kernel: ``csrc/nm_spmv.cu`` (CUDA C++, sm_90a).  It replaces the TPU kernel
``repro/kernels/nm_spmv.py::nm_spmv_kernel`` (gather body, wrapper
``repro/kernels/ops.py::nm_spmv``).  On the H100 it is bound by device-memory
bytes: each compressed weight row (values + int8 indices) is read once per
call, and the N/M-sparse MACs are far below the FMA rate.  The design keeps
the TPU's resident-activation idea — a K-chunk of x for up to 8 batch rows
is staged in shared memory with 16-byte loads — and streams two weight rows
per warp with coalesced loads, f32 accumulation and a warp-shuffle
reduction.  Any batch B >= 1 is taken as it is (no pad-to-8); batches
above 8 use more CTAs.

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

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel,
                                       check_cuda_operand)
from repro_torch.kernels.nm_spmm import (_PLAN_ARGS, BK, launch_planned,
                                         mma_plan, nm_xwt_plain, sm_count)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
KERNEL = CudaKernel("nm_spmv", "nm_spmv_launch", _ARGS)
ONEHOT_KERNEL = CudaKernel("nm_spmv_onehot", "nm_spmv_onehot_launch",
                           _PLAN_ARGS, lib="nm_spmv")
MODES = ("gather", "onehot")


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
            n: int, m: int, mode: str = "gather") -> torch.Tensor:
    """Y = X @ W_sp.T for a decode-shaped X [..., K]; W compressed
    [O, K/M*N].  ``mode`` picks the body: ``"gather"`` (N/M of the MACs,
    indexed reads of x) or ``"onehot"`` (decompress, dense dot).  A CUDA
    tensor launches that body's kernel (or raises); a CPU tensor takes
    ``nm_spmv_plain`` / ``nm_spmv_onehot_plain``."""
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
        plan = mma_plan(bsz, o, k, n, m, sm_count(x.device), decode=True) \
            if x.dtype == torch.bfloat16 and bsz and o else None
        y = launch_planned(ONEHOT_KERNEL, xf, values, indices, n, m, plan)
        return y.reshape(*lead, o)
    y = torch.empty(bsz, o, dtype=x.dtype, device=x.device)
    if bsz and o:
        KERNEL.launch(xf.data_ptr(), values.data_ptr(), indices.data_ptr(),
                      y.data_ptr(), bsz, o, k, n, m, DTYPE_CODES[x.dtype])
    return y.reshape(*lead, o)
