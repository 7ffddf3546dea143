"""SparseLinear — the switch that makes any architecture N:M-sparse
(counterpart of ``repro.core.layers``).

A ``SparseLinear`` holds either a dense weight ``w`` [out, in] or the
compressed pair ``w_vals`` / ``w_idx`` [out, in/M*N], plus an optional bias
``b``.  A ``StackedLinear`` is the same for a stack of experts, [E, out,
in] / [E, out, in/M*N]; the MoE layer reads it through ``dense_view``.
``linear_apply`` runs a ``SparseLinear`` under a ``SparsityConfig``:

  dense       plain dense product
  srste       dense weight, N:M magnitude mask applied in the forward (the
              straight-through training gradients come with the training
              port)
  compressed  values + indices through ``nm_matmul`` (impl chosen by
              ``select_impl``); dense leaves not yet converted get the mask

``convert_to_compressed`` is the offline prune-and-pack step (stacks
compress along their last axis unchanged).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.sparse_matmul import (SparsityConfig, dense_forward_view,
                                            matmul_f32acc, nm_matmul,
                                            select_impl)
from repro_torch.core.sparsity import NMSparse, compress, decompress_parts


class SparseLinear(nn.Module):
    """Weights of one linear, stored [out, in] (the paper's A layout).  The
    tensors are buffers: the port serves, it does not train yet."""

    def __init__(self, w: Optional[torch.Tensor] = None,
                 w_vals: Optional[torch.Tensor] = None,
                 w_idx: Optional[torch.Tensor] = None,
                 b: Optional[torch.Tensor] = None):
        super().__init__()
        if (w is None) == (w_vals is None) or (w_vals is None) != (w_idx is None):
            raise ValueError("SparseLinear holds either w or (w_vals, w_idx)")
        for name, t in (("w", w), ("w_vals", w_vals), ("w_idx", w_idx),
                        ("b", b)):
            if t is not None:
                self.register_buffer(name, t)

    @property
    def compressed(self) -> bool:
        return hasattr(self, "w_vals")

    def has(self, name: str) -> bool:
        return name in self._buffers


class StackedLinear(SparseLinear):
    """Stacked expert weights [E, out, in] (or the compressed [E, out,
    in/M*N] pair), sparse along ``in`` like every other projection.  Not
    applied through ``linear_apply``: the MoE layer multiplies its
    ``dense_view`` in one batched product per stack."""


def dense_view(p: SparseLinear, cfg: SparsityConfig) -> torch.Tensor:
    """Dense [..., out, in] view of a (stacked) linear's weight, consistent
    with what ``linear_apply`` multiplies by: compressed leaves decompress
    (the reference's slot-loop order), dense ones take
    ``dense_forward_view``."""
    if p.compressed:
        k = p.w_vals.shape[-1] * cfg.m // cfg.n
        return decompress_parts(p.w_vals, p.w_idx, cfg.n, cfg.m, k)
    return dense_forward_view(p.w, cfg)


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                cfg: SparsityConfig, dtype=torch.bfloat16,
                device="cuda", use_bias: bool = False,
                scale: Optional[float] = None) -> SparseLinear:
    """Normal(0, scale^2) weight [out, in] drawn from ``gen`` (on
    ``device``); compressed at init under ``mode='compressed'``."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = (torch.randn((out_dim, in_dim), generator=gen, device=device,
                     dtype=torch.float32) * scale).to(dtype)
    b = torch.zeros(out_dim, dtype=dtype, device=device) if use_bias else None
    if cfg.applies(in_dim, out_dim) and cfg.mode == "compressed":
        sp = compress(w, cfg.n, cfg.m)
        return SparseLinear(w_vals=sp.values, w_idx=sp.indices, b=b)
    if cfg.mode == "fixed":
        raise NotImplementedError("mode='fixed' (stored masks) comes with the "
                                  "training port")
    return SparseLinear(w=w, b=b)


def linear_apply(p: SparseLinear, x: torch.Tensor, cfg: SparsityConfig,
                 in_dim: Optional[int] = None) -> torch.Tensor:
    in_dim = in_dim if in_dim is not None else x.shape[-1]
    if p.compressed:   # serving path: impl chosen by the shape/device policy
        out_dim = p.w_vals.shape[0]
        sp = NMSparse(p.w_vals, p.w_idx, cfg.n, cfg.m, (out_dim, in_dim))
        # the kernels read x as dense rows (an MLA latent slice is strided)
        y = nm_matmul(x.contiguous(), sp, impl=select_impl(cfg, x))
    else:
        y = matmul_f32acc(x, dense_forward_view(p.w, cfg))
    if p.has("b"):
        y = y + p.b
    return y


def convert_to_compressed(p: SparseLinear, cfg: SparsityConfig
                          ) -> SparseLinear:
    """Dense layer -> compressed serving format (offline packing step); a
    ``StackedLinear`` stays one.  Returns ``p`` itself when already
    compressed or skipped by the policy."""
    if p.compressed:
        return p
    out_dim, in_dim = p.w.shape[-2:]
    if not cfg.applies(in_dim, out_dim):
        return p
    sp = compress(p.w, cfg.n, cfg.m)
    return type(p)(w_vals=sp.values, w_idx=sp.indices,
                   b=p.b if p.has("b") else None)
