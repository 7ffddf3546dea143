"""SparseLinear — the switch that makes any architecture N:M-sparse
(counterpart of ``repro.core.layers``).

A ``SparseLinear`` holds either a dense weight ``w`` [out, in] or the
compressed pair ``w_vals`` / ``w_idx`` [out, in/M*N], plus an optional bias
``b``.  ``linear_apply`` runs it under a ``SparsityConfig``:

  dense       plain dense product
  srste       dense weight, N:M magnitude mask applied in the forward (the
              straight-through training gradients come with the training
              port)
  compressed  values + indices through ``nm_matmul`` (impl chosen by
              ``select_impl``); dense leaves not yet converted get the mask

``convert_to_compressed`` is the offline prune-and-pack step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.sparse_matmul import (SparsityConfig, masked_matmul,
                                            matmul_f32acc, nm_matmul,
                                            select_impl)
from repro_torch.core.sparsity import NMSparse, compress, nm_mask


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
        y = nm_matmul(x, sp, impl=select_impl(cfg, x))
    else:
        w = p.w
        if cfg.applies(in_dim, w.shape[0]) and cfg.mode in ("srste",
                                                            "compressed"):
            y = masked_matmul(x, w, nm_mask(w, cfg.n, cfg.m))
        else:
            y = matmul_f32acc(x, w)
    if p.has("b"):
        y = y + p.b
    return y


def convert_to_compressed(p: SparseLinear, cfg: SparsityConfig
                          ) -> SparseLinear:
    """Dense layer -> compressed serving format (offline packing step).
    Returns ``p`` itself when already compressed or skipped by the policy."""
    if p.compressed:
        return p
    out_dim, in_dim = p.w.shape
    if not cfg.applies(in_dim, out_dim):
        return p
    sp = compress(p.w, cfg.n, cfg.m)
    return SparseLinear(w_vals=sp.values, w_idx=sp.indices,
                        b=p.b if p.has("b") else None)
