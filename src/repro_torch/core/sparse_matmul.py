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
CPU tensor to ``plain``.  ``dense_forward_view`` is the dense weights'
forward semantics, shared by ``linear_apply``, the MoE expert stacks and
the MLA absorbed decode.  The TP ring, SR-STE training (``ste_sparsify``),
``nm_rerank`` and the fixed-mask mode (``masked_matmul``) are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import NMSparse, decompress_parts, nm_mask
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


def bmm_f32acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched x [E, C, K] @ w[E, O, K]^T with f32 accumulation, result in
    x.dtype (the reference's stacked-expert ``einsum(...,
    preferred_element_type=float32)``)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.bmm(x, w.transpose(1, 2))
    if x.is_cuda:                   # cuBLAS accumulates bf16 products in f32
        return torch.bmm(x, w.to(x.dtype).transpose(1, 2))
    return torch.bmm(x.float(), w.float().transpose(1, 2)).to(x.dtype)


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


def dense_forward_view(w: torch.Tensor, sp: SparsityConfig) -> torch.Tensor:
    """Dense view [..., out, in] of a dense-stored weight with the forward
    semantics ``linear_apply`` uses: under 'srste' and under a not yet
    converted 'compressed' policy the magnitude N:M mask applies (never
    silently unmasked).  Shared by the MoE stacked products and the MLA
    absorbed decode, so those paths cannot diverge from the per-linear one.
    (The reference's srste branch carries straight-through gradients; the
    port serves and computes the same forward.)"""
    if not sp.applies(w.shape[-1], w.shape[-2]):
        return w
    if sp.mode in ("srste", "compressed"):
        return w * nm_mask(w, sp.n, sp.m).to(w.dtype)
    return w
