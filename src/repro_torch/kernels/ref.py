"""Plain-torch oracles for the N:M sparse matmuls (counterpart of
``repro.kernels.ref``): decompress to dense, then a dense contraction in
float32.  Deliberately the most obvious formulation; they run on any device
and are what ``impl="ref"`` pins."""

from __future__ import annotations

import torch

from repro_torch.core.sparsity import decompress_parts


def nm_decompress_ref(values: torch.Tensor, indices: torch.Tensor, n: int,
                      m: int, k: int) -> torch.Tensor:
    """[rows, nnz] values + int8 in-block indices -> dense [rows, k]."""
    rows, nnz = values.shape
    if nnz != k // m * n:
        raise ValueError(f"values {tuple(values.shape)} do not match "
                         f"k={k} at {n}:{m}")
    return decompress_parts(values, indices, n, m, k)


def nm_spmm_ref(values: torch.Tensor, indices: torch.Tensor, b: torch.Tensor,
                n: int, m: int) -> torch.Tensor:
    """Paper orientation: C = A_sparse @ B.  A compressed [R, nnz], B [K, C]."""
    a = nm_decompress_ref(values, indices, n, m, b.shape[0])
    return (a.float() @ b.float()).to(b.dtype)


def nm_xwt_ref(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
               n: int, m: int) -> torch.Tensor:
    """Layer orientation: Y = X @ W_sparse.T.  X [..., K], W compressed
    [O, nnz]."""
    w = nm_decompress_ref(values, indices, n, m, x.shape[-1])
    return torch.einsum("...k,ok->...o", x.float(), w.float()).to(x.dtype)


def nm_spmv_ref(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                n: int, m: int) -> torch.Tensor:
    """Decode orientation, gather-MAC form: Y[b, o] = sum_e vals[o, e] *
    x[b, block(e)*M + idx[o, e]] — numerically nm_xwt_ref, expressed the way
    the decode kernel executes it."""
    o, nnz = values.shape
    blk = (torch.arange(nnz, device=x.device) // n) * m
    full_idx = blk.unsqueeze(0) + indices.long()              # [o, nnz]
    gathered = x.float()[:, full_idx]                         # [b, o, nnz]
    y = torch.einsum("boe,oe->bo", gathered, values.float())
    return y.to(x.dtype)
