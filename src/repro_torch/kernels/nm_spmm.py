"""The tiled N:M sparse-dense products, both orientations of the reference's
``repro/kernels/nm_spmm.py``:

  nm_xwt         Y[S, O] = X[S, K] . W_sp^T (layer orientation), W's
                 indices int8
  nm_xwt_packed  the same, W's indices as the paper's bit-packed words
  nm_spmm        C[R, C] = A_sp[R, K] . B[K, C] (the paper's orientation)

Kernel: ``csrc/nm_xwt.cu`` (CUDA C++, sm_90a), one kernel body per dtype
for all three; the decompress is shared with the onehot decode body
(``csrc/nm_tile.cuh``).  It replaces the TPU kernels
``repro/kernels/nm_spmm.py::nm_xwt_kernel`` (``_xwt_body`` +
``_decompress_tile``; ``packed=True`` adds ``_unpack_indices_tile``) and
``::nm_spmm_kernel`` (``_spmm_body``), wrappers ``repro/kernels/ops.py``.
At serving prefill lengths the compressed weight bytes bound it on the
H100; at the CNN GEMMs' widths the operations.  Design: one CTA per output
tile loops over K; each step stages the dense tile and decompresses the
compressed tile (values + indices -> dense, ``block*M + idx`` placement)
into shared memory.  bf16 tiles go through ``mma.sync`` tensor-core
products with f32 accumulators; f32 tiles through an f32 FMA loop.  The
packed variant differs only in its index reads (word ``e // per_word``,
shift ``(e % per_word) * bits``), so its output equals the int8 kernel's bit
for bit.  Ragged edges are masked in the kernel, not padded.  TMA, ``wgmma``
and a multi-stage pipeline are later work.

``nm_xwt_plain``, ``nm_xwt_packed_plain`` and ``nm_spmm_plain`` are the same
functions in plain torch: the CPU path, and what the kernels are held
against on the card.  Each launcher has its own launch counter (``KERNEL``,
``PACKED_KERNEL``, ``SPMM_KERNEL``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparsity import (decompress_parts, index_bits,
                                       unpack_indices)
from repro_torch.kernels.ref import nm_spmm_ref
from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel,
                                       check_cuda_operand)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
KERNEL = CudaKernel("nm_xwt", "nm_xwt_launch", _ARGS)
PACKED_KERNEL = CudaKernel("nm_xwt_packed", "nm_xwt_packed_launch", _ARGS,
                           lib="nm_xwt")
SPMM_KERNEL = CudaKernel("nm_spmm", "nm_spmm_launch", _ARGS, lib="nm_xwt")
BK = 64     # the kernel's K step: M must divide it


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
    rows = xf.shape[0]
    y = torch.empty(rows, o, dtype=x.dtype, device=x.device)
    if rows and o:
        kernel.launch(xf.data_ptr(), values.data_ptr(), idx.data_ptr(),
                      y.data_ptr(), rows, o, k, n, m, DTYPE_CODES[x.dtype])
    return y.reshape(*lead, o)


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
