"""Prefill-shaped N:M sparse linear: Y[S, O] = X[S, K] . W_sp^T.

Kernel: ``csrc/nm_xwt.cu`` (CUDA C++, sm_90a).  It replaces the TPU kernel
``repro/kernels/nm_spmm.py::nm_xwt_kernel`` (``_xwt_body`` +
``_decompress_tile``, int8 indices; wrapper ``repro/kernels/ops.py::nm_xwt``).
At serving prefill lengths the compressed weight bytes bound it on the
H100.  Design: one CTA per output tile loops over K; each step stages the X
tile and decompresses the W tile (values + indices -> dense, ``block*M +
idx`` placement) into shared memory.  bf16 tiles go through ``mma.sync``
tensor-core products with f32 accumulators; f32 tiles through an f32 FMA
loop.  Ragged edges are masked in the kernel, not padded.  TMA, ``wgmma``
and a multi-stage pipeline are later work.

The paper-orientation ``nm_spmm`` (C = A_sp @ B) and the bit-packed index
variant of ``nm_xwt`` are not on the serving path and are not ported yet.

``nm_xwt_plain`` is the same function in plain torch: the CPU path, and what
the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparsity import decompress_parts
from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel,
                                       check_cuda_operand)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("nm_xwt", "nm_xwt_launch",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
BK = 64     # the kernel's K step: M must divide it


def nm_xwt_plain(x: torch.Tensor, values: torch.Tensor,
                 indices: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """x [S, K] -> [S, O] in x.dtype: decompress W to f32 (the kernel's
    tile decompress), then an f32 product."""
    w = decompress_parts(values, indices, n, m, x.shape[-1],
                         dtype=torch.float32)
    return (x.float() @ w.t()).to(x.dtype)


def nm_xwt(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
           n: int, m: int) -> torch.Tensor:
    """Y = X @ W_sp.T for X [..., K] of any leading shape; W compressed
    [O, K/M*N], int8 indices.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes ``nm_xwt_plain``."""
    lead, k = x.shape[:-1], x.shape[-1]
    o, nnz = values.shape
    if nnz != k // m * n or k % m:
        raise ValueError(f"values {tuple(values.shape)} do not match K={k} "
                         f"at {n}:{m}")
    xf = x.reshape(-1, k)
    if not x.is_cuda:
        return nm_xwt_plain(xf, values, indices, n, m).reshape(*lead, o)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"nm_xwt kernel takes float32/bfloat16, got {x.dtype}")
    if not 0 < n < m or BK % m:
        raise ValueError(f"nm_xwt kernel needs 0 < n < m with m dividing "
                         f"{BK}, got {n}:{m}")
    check_cuda_operand("x", xf, x.device)
    check_cuda_operand("values", values, x.device, x.dtype)
    check_cuda_operand("indices", indices, x.device, torch.int8)
    rows = xf.shape[0]
    y = torch.empty(rows, o, dtype=x.dtype, device=x.device)
    if rows and o:
        KERNEL.launch(xf.data_ptr(), values.data_ptr(), indices.data_ptr(),
                      y.data_ptr(), rows, o, k, n, m, DTYPE_CODES[x.dtype])
    return y.reshape(*lead, o)
