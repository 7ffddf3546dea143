"""Sparse-linear execution policy (counterpart of ``repro.core.sparse_matmul``).

One entry point, ``nm_matmul``, with these implementations:

  ref    decompress -> dense f32 product (the oracle, ``kernels/ref.py``);
         runs on any device — ``impl="ref"`` pinned explicitly is the
         reference knob, never a fallback
  plain  slot-loop decompress -> dense product with f32 accumulation: the
         CPU path (the reference's ``"xla"`` route)
  xwt    the tiled CUDA kernel (``kernels/nm_spmm.py``; the reference's
         ``"pallas"``)
  spmv   the decode CUDA kernel (``kernels/nm_spmv.py``)

Under ``impl="auto"`` ``select_impl`` routes by device and shape: a CUDA
tensor goes to the kernels (decode-shaped -> spmv, other shapes -> xwt), a
CPU tensor to ``plain``.  The TP ring, SR-STE training (``ste_sparsify``) and
``nm_rerank`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import NMSparse, decompress_parts
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Impl = str  # 'auto' | 'ref' | 'plain' | 'xwt' | 'spmv'


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Per-model sparsity policy (threaded through every SparseLinear).

    ``mode``: 'srste' (dense weight, N:M mask recomputed in the forward),
    'compressed' (values + indices; dense leaves not yet converted get the
    magnitude mask), 'dense'.  ``decode_batch_max`` bounds the rank-2 batch
    that counts as decode-shaped."""
    n: int = 2
    m: int = 4
    enabled: bool = True
    mode: str = "srste"
    impl: Impl = "auto"
    min_dim: int = 128
    decode_batch_max: int = 8

    def applies(self, in_dim: int, out_dim: int) -> bool:
        return (self.enabled and self.mode != "dense"
                and in_dim % self.m == 0
                and min(in_dim, out_dim) >= self.min_dim)


def matmul_f32acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w[O, K].T with f32 accumulation, result in x.dtype (the
    reference's ``preferred_element_type=float32`` einsum)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w.t()
    if x.is_cuda:                   # cuBLAS accumulates bf16 products in f32
        return F.linear(x, w.to(x.dtype))
    return (x.float() @ w.float().t()).to(x.dtype)


def _xwt_plain(x, values, indices, n, m):
    w = decompress_parts(values, indices, n, m, x.shape[-1])
    return matmul_f32acc(x, w)


def is_decode_shape(x_shape: Tuple[int, ...], batch_max: int = 8) -> bool:
    """True when x is decode-shaped: a single-token step [..., 1, K] (the
    serve engine's [B, 1, d] activations) or a rank-2 small-batch matvec."""
    if len(x_shape) >= 3:
        return x_shape[-2] == 1
    return len(x_shape) == 2 and x_shape[0] <= batch_max


def select_impl(cfg: SparsityConfig, x: torch.Tensor) -> Impl:
    """The execution policy for compressed params: a pinned ``cfg.impl``
    wins; under 'auto' CUDA tensors take the kernels (decode-shaped ->
    spmv, else xwt) and CPU tensors the plain path."""
    if cfg.impl != "auto":
        return cfg.impl
    if not x.is_cuda:
        return "plain"
    return "spmv" if is_decode_shape(tuple(x.shape), cfg.decode_batch_max) \
        else "xwt"


def nm_matmul(x: torch.Tensor, sp: NMSparse, impl: Impl = "auto"
              ) -> torch.Tensor:
    """Y = x @ W_sp.T (layer orientation). x [..., K], sp dense_shape [O, K]."""
    n, m = sp.n, sp.m
    if impl == "auto":
        impl = "xwt" if x.is_cuda else "plain"
    if impl == "ref":
        lead = x.shape[:-1]
        y = kref.nm_xwt_ref(x.reshape(-1, x.shape[-1]), sp.values,
                            sp.indices, n, m)
        return y.reshape(*lead, -1)
    if impl == "plain":
        return _xwt_plain(x, sp.values, sp.indices, n, m)
    if impl == "xwt":
        return kops.nm_xwt(x, sp.values, sp.indices, n, m)
    if impl == "spmv":
        return kops.nm_spmv(x, sp.values, sp.indices, n, m)
    raise ValueError(f"unknown impl {impl!r} (ported: auto, ref, plain, "
                     f"xwt, spmv; 'ring' comes with tensor-parallel serving)")


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """Fixed-mask product: x @ (w * mask).T with f32 accumulation."""
    return matmul_f32acc(x, w * mask.to(w.dtype))
