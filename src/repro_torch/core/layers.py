"""SparseLinear — the switch that makes any architecture N:M-sparse
(counterpart of ``repro.core.layers``).

A ``SparseLinear`` holds either a dense weight ``w`` [out, in] (with a
frozen boolean ``mask`` under 'fixed') or the compressed pair ``w_vals`` /
``w_idx`` [out, in/M*N], plus an optional bias ``b``.  ``w`` and ``b`` are
parameters, created with ``requires_grad=False`` (the trainer turns them
on); the compressed pair and the mask are buffers.  A ``StackedLinear`` is
the same for a stack of experts, [E, out, in] / [E, out, in/M*N]; the MoE
layer reads it through ``dense_view``.
``linear_apply`` runs a ``SparseLinear`` under a ``SparsityConfig``:

  dense       plain dense product
  srste       dense weight, N:M mask recomputed in every forward, with
              straight-through gradients (``nm_matmul_ste``)
  fixed       dense weight times its stored mask (``masked_matmul``)
  compressed  values + indices through ``nm_matmul`` (impl chosen by
              ``select_impl``); dense leaves not yet converted get the mask

``convert_to_compressed`` is the offline prune-and-pack step (a stored
mask applies first; stacks compress along their last axis unchanged).

Tensor-parallel serving: ``models.transformer.shard_model`` cuts a
linear's output rows (and its bias) to this rank's shard and records the
whole row count in ``tp_rows``.  ``linear_apply`` then runs the shard
inside the active serving mesh: under the compressed ring (decode shapes,
``select_impl`` -> 'ring') every shard passes through every rank and the
output is whole; otherwise the rank multiplies its own rows, with the
whole shape's launch plan, and all-gathers the feature axis.  Either
way the output is whole on every rank unless the caller asks for its
``local`` part (the attention's per-head projections).  No contraction is
split, so every output element sums in the one-device order.  Training
over a mesh's "model" axis runs the same rows: the input passes
``reduce_grad`` (each rank's dX is its rows' part of the sum) and the
all-gather's backward keeps the rank's slice of the cotangent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core.sparse_matmul import (SparsityConfig, dense_forward_view,
                                            masked_matmul, matmul_f32acc,
                                            nm_matmul, nm_matmul_ste,
                                            select_impl)
from repro_torch.core.sparsity import (NMSparse, compress, decompress_parts,
                                       nm_mask)


class SparseLinear(nn.Module):
    """Weights of one linear, stored [out, in] (the paper's A layout)."""

    def __init__(self, w: Optional[torch.Tensor] = None,
                 w_vals: Optional[torch.Tensor] = None,
                 w_idx: Optional[torch.Tensor] = None,
                 b: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None):
        super().__init__()
        if (w is None) == (w_vals is None) or (w_vals is None) != (w_idx is None):
            raise ValueError("SparseLinear holds either w or (w_vals, w_idx)")
        if mask is not None and w is None:
            raise ValueError("a stored mask belongs to a dense weight")
        for name, t in (("w", w), ("b", b)):
            if t is not None:
                self.register_parameter(name, nn.Parameter(
                    t.detach(), requires_grad=False))
        for name, t in (("w_vals", w_vals), ("w_idx", w_idx),
                        ("mask", mask)):
            if t is not None:
                self.register_buffer(name, t)

    @property
    def compressed(self) -> bool:
        return hasattr(self, "w_vals")

    def has(self, name: str) -> bool:
        return name in self._buffers or name in self._parameters


class StackedLinear(SparseLinear):
    """Stacked expert weights [E, out, in] (or the compressed [E, out,
    in/M*N] pair), sparse along ``in`` like every other projection.  Not
    applied through ``linear_apply``: the MoE layer multiplies its
    ``dense_view`` in one batched product per stack."""


def whole_rows(p: SparseLinear) -> int:
    """The output rows of the whole weight (``tp_rows`` for a shard)."""
    rows = (p.w_vals if p.compressed else p.w).shape[-2]
    return getattr(p, "tp_rows", None) or rows


def dense_view(p: SparseLinear, cfg: SparsityConfig) -> torch.Tensor:
    """Dense [..., out, in] view of a (stacked) linear's weight, consistent
    with what ``linear_apply`` multiplies by: compressed leaves decompress
    (the reference's slot-loop order), dense ones take
    ``dense_forward_view``.  A row shard gives its own rows (the policy
    decided on the whole weight's)."""
    if p.compressed:
        k = p.w_vals.shape[-1] * cfg.m // cfg.n
        return decompress_parts(p.w_vals, p.w_idx, cfg.n, cfg.m, k)
    return dense_forward_view(p.w, cfg, getattr(p, "mask", None),
                              out_dim=whole_rows(p))


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                cfg: SparsityConfig, dtype=torch.bfloat16,
                device="cuda", use_bias: bool = False,
                scale: Optional[float] = None) -> SparseLinear:
    """Normal(0, scale^2) weight [out, in] drawn from ``gen`` (on
    ``device``); compressed at init under ``mode='compressed'``, its
    magnitude mask stored under ``mode='fixed'``."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = (torch.randn((out_dim, in_dim), generator=gen, device=device,
                     dtype=torch.float32) * scale).to(dtype)
    b = torch.zeros(out_dim, dtype=dtype, device=device) if use_bias else None
    if cfg.applies(in_dim, out_dim):
        if cfg.mode == "compressed":
            sp = compress(w, cfg.n, cfg.m)
            return SparseLinear(w_vals=sp.values, w_idx=sp.indices, b=b)
        if cfg.mode == "fixed":
            return SparseLinear(w=w, b=b, mask=nm_mask(w, cfg.n, cfg.m))
    return SparseLinear(w=w, b=b)


def linear_apply(p: SparseLinear, x: torch.Tensor, cfg: SparsityConfig,
                 in_dim: Optional[int] = None, local: bool = False
                 ) -> torch.Tensor:
    """y = x @ W.T (+ b) under ``cfg``.  Inside a serving mesh a row shard
    (``tp_rows``) runs tensor-parallel (module docstring) and returns the
    whole output, or with ``local`` this rank's 1/n of the output
    features; ``local`` on a linear the mesh leaves whole cuts its output
    the same way."""
    in_dim = in_dim if in_dim is not None else x.shape[-1]
    if getattr(p, "tp_rows", None):
        return _tp_linear_apply(p, x, cfg, in_dim, local)
    if p.compressed:   # serving path: impl chosen by the shape/device policy
        out_dim = p.w_vals.shape[0]
        sp = NMSparse(p.w_vals, p.w_idx, cfg.n, cfg.m, (out_dim, in_dim))
        # the kernels read x as dense rows (an MLA latent slice is strided)
        y = nm_matmul(x.contiguous(), sp, impl=select_impl(cfg, x))
    else:
        y = _dense_product(p, x, cfg, in_dim, p.w.shape[0])
    if p.has("b"):
        y = y + p.b
    if local:
        from repro_torch.dist.api import require_mesh
        from repro_torch.dist.collectives import split_last
        return split_last(y, require_mesh("a local output"))
    return y


def _dense_product(p: SparseLinear, x, cfg: SparsityConfig, in_dim: int,
                   out_dim: int) -> torch.Tensor:
    """x @ W.T for a dense-stored weight under the mode's semantics;
    ``out_dim`` is the whole weight's rows, on which the policy decides."""
    if p.has("mask"):
        return masked_matmul(x, p.w, p.mask)
    if cfg.applies(in_dim, out_dim) and cfg.mode == "srste":
        return nm_matmul_ste(x, p.w, cfg.n, cfg.m, cfg.srste_lam)
    return matmul_f32acc(x, dense_forward_view(p.w, cfg, out_dim=out_dim))


def _tp_linear_apply(p: SparseLinear, x: torch.Tensor, cfg: SparsityConfig,
                     in_dim: int, local: bool) -> torch.Tensor:
    """A row shard's ``linear_apply``: the compressed ring (whole output on
    every rank), or the local rows under the whole shape's plan, then an
    all-gather of the feature axis unless ``local``."""
    from repro_torch.dist.api import require_mesh
    from repro_torch.dist.collectives import all_gather_last, reduce_grad
    mesh = require_mesh("this linear")
    o = p.tp_rows
    if p.compressed:
        o_loc = p.w_vals.shape[0]
        sp = NMSparse(p.w_vals, p.w_idx, cfg.n, cfg.m, (o_loc, in_dim))
        impl = select_impl(cfg, x)
        if impl == "ring":
            inner = select_impl(dataclasses.replace(cfg, decode_ring=False),
                                x)
            y = nm_matmul(x.contiguous(), sp, "ring", plan_o=o,
                          ring_impl=inner)
            if p.has("b"):
                y = y + all_gather_last(p.b, mesh)
            return y.narrow(-1, mesh.rank * o_loc, o_loc) if local else y
        y = nm_matmul(x.contiguous(), sp, impl=impl, plan_o=o)
    else:
        y = _dense_product(p, reduce_grad(x, mesh), cfg, in_dim, o)
    if p.has("b"):
        y = y + p.b
    return y if local else all_gather_last(y, mesh)


def convert_to_compressed(p: SparseLinear, cfg: SparsityConfig
                          ) -> SparseLinear:
    """Trained (srste / fixed / dense) layer -> compressed serving format
    (offline packing step; a stored mask applies first); a
    ``StackedLinear`` stays one.  Returns ``p`` itself when already
    compressed or skipped by the policy.  The packed tensors carry no
    autograd history."""
    if p.compressed:
        return p
    out_dim, in_dim = p.w.shape[-2:]
    if not cfg.applies(in_dim, out_dim):
        return p
    with torch.no_grad():
        w = p.w * p.mask.to(p.w.dtype) if p.has("mask") else p.w
        sp = compress(w, cfg.n, cfg.m)
    return type(p)(w_vals=sp.values, w_idx=sp.indices,
                   b=p.b if p.has("b") else None)
