"""Sparse-linear execution policy (counterpart of ``repro.core.sparse_matmul``).

One entry point, ``nm_matmul``, with these implementations:

  ref          decompress -> dense f32 product (the oracle,
               ``kernels/ref.py``); runs on any device — ``impl="ref"``
               pinned explicitly is the reference knob, never a fallback
  plain        slot-loop decompress -> dense product with f32
               accumulation: the CPU path (the reference's ``"xla"``)
  xwt          the tiled CUDA kernel (``kernels/nm_spmm.py``; the
               reference's ``"pallas"``)
  spmv         the decode CUDA kernel, gather body (``kernels/nm_spmv.py``;
               the reference's ``"spmv"`` / ``"spmv_gather"``)
  spmv_onehot  the decode CUDA kernel, onehot body (decompress + dense dot;
               the reference's ``"spmv_onehot"``)

Under ``impl="auto"`` ``select_impl`` routes by device and shape: a pinned
``decode_impl`` wins for decode shapes; otherwise a CUDA tensor goes to the
kernels (decode-shaped -> spmv, or spmv_onehot under
``spmv_mode="onehot"``; other shapes -> xwt) and a CPU tensor to ``plain``.
``dense_forward_view`` is the dense weights' forward semantics, shared by
``linear_apply``, the MoE expert stacks and the MLA absorbed decode.
``nm_rerank`` re-ranks stored n:m operands down to keep:m (the speculative
draft's sparsity ladder).

SR-STE training: ``ste_sparsify`` is the N:M magnitude mask with the
straight-through gradient plus the SR-STE decay on the pruned complement
(an autograd Function acting on the weight only, so it composes with any
product); ``nm_matmul_ste`` and ``masked_matmul`` (a frozen boolean mask,
the 'fixed' mode) are the f32-accumulated products over it.

Tensor-parallel serving: with ``decode_ring`` set (the engine sets it
under ``mesh=`` with compressed weights and ``tp_collective`` 'auto' or
'ring') and a serving mesh of more than one rank active, ``select_impl``
routes decode shapes to ``"ring"``: ``nm_matmul`` then runs
``dist.collectives.ring_sparse_linear`` on this rank's shard of the rows,
whose compressed values and packed indices rotate round the ranks, each
step's product through the impl the policy picks without the ring.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import NMSparse, decompress_parts, nm_mask
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Impl = str  # 'auto' | 'ref' | 'plain' | 'xwt' | 'spmv' | 'spmv_onehot'
            # | 'ring' (tensor-parallel serving: the compressed ring)


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Per-model sparsity policy (threaded through every SparseLinear).

    ``mode``: 'srste' (dense weight, N:M mask recomputed in the forward,
    straight-through gradients with the ``srste_lam`` decay on pruned
    weights), 'fixed' (dense weight and a frozen boolean mask),
    'compressed' (values + indices; dense leaves not yet converted get the
    magnitude mask), 'dense'.  ``decode_batch_max`` bounds the rank-2 batch
    that counts as decode-shaped.

    Decode policy, as the reference's fields: ``decode_impl`` pins the impl
    of decode-shaped inputs under ``impl='auto'`` ('auto' resolves by
    device; the reference's 'pallas' is the port's 'xwt', its 'xla' the
    port's 'plain'); ``spmv_mode`` picks the decode kernel's body on the
    card, 'gather' (``spmv``) or 'onehot' (``spmv_onehot``).

    ``decode_ring`` routes decode-shaped compressed products through the
    sparse ring while a serving mesh of more than one rank is active (the
    reference's field)."""
    n: int = 2
    m: int = 4
    enabled: bool = True
    mode: str = "srste"
    impl: Impl = "auto"
    srste_lam: float = 2e-4
    min_dim: int = 128
    decode_impl: Impl = "auto"
    decode_batch_max: int = 8
    spmv_mode: str = "gather"
    decode_ring: bool = False

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


def nm_rerank(values: torch.Tensor, indices: torch.Tensor, n: int, m: int,
              keep: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank an n:m compressed tensor down to keep:m on its stored
    operands (the dense weight is never built): within each m-block the
    ``keep`` largest-magnitude of the n stored entries survive, in
    ascending in-block column order.  values / indices [..., rows, nnz]
    (stacked expert leaves included) -> the same layout with nnz // n * keep.

    Ties go to the lowest stored slot, as ``jax.lax.top_k`` in the
    reference: ``torch.topk`` promises no tie order, so a stable descending
    sort ranks the slots instead."""
    if not 0 < keep < n:
        raise ValueError(f"need 0 < keep < n, got keep={keep} n={n}")
    nnz = values.shape[-1]
    if nnz % n:
        raise ValueError(f"nnz {nnz} not divisible by n={n}")
    g = nnz // n
    v = values.reshape(values.shape[:-1] + (g, n))
    i = indices.reshape(indices.shape[:-1] + (g, n))
    sel = torch.sort(v.float().abs(), dim=-1, descending=True,
                     stable=True).indices[..., :keep]
    vs, ix = v.gather(-1, sel), i.gather(-1, sel)
    order = torch.sort(ix, dim=-1, stable=True).indices
    out = values.shape[:-1] + (g * keep,)
    return (vs.gather(-1, order).reshape(out),
            ix.gather(-1, order).reshape(out))


def is_decode_shape(x_shape: Tuple[int, ...], batch_max: int = 8) -> bool:
    """True when x is decode-shaped: a single-token step [..., 1, K] (the
    serve engine's [B, 1, d] activations) or a rank-2 small-batch matvec."""
    if len(x_shape) >= 3:
        return x_shape[-2] == 1
    return len(x_shape) == 2 and x_shape[0] <= batch_max


def ring_mesh():
    """The active serving mesh when it has more than one rank, else None."""
    from repro_torch.dist.api import current_mesh
    mesh = current_mesh()
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        return mesh
    return None


def select_impl(cfg: SparsityConfig, x: torch.Tensor) -> Impl:
    """The execution policy for compressed params: a pinned ``cfg.impl``
    wins; under 'auto' decode shapes take 'ring' while ``cfg.decode_ring``
    is set and a serving mesh of more than one rank is active, else a
    pinned ``cfg.decode_impl``; otherwise CUDA tensors take the kernels
    (decode-shaped -> spmv, or spmv_onehot under ``spmv_mode='onehot'``;
    else xwt) and CPU tensors the plain path."""
    if cfg.impl != "auto":
        return cfg.impl
    decode = is_decode_shape(tuple(x.shape), cfg.decode_batch_max)
    if decode and cfg.decode_ring and ring_mesh() is not None:
        return "ring"
    if decode and cfg.decode_impl != "auto":
        return cfg.decode_impl
    if not x.is_cuda:
        return "plain"
    if decode:
        return "spmv_onehot" if cfg.spmv_mode == "onehot" else "spmv"
    return "xwt"


def nm_matmul(x: torch.Tensor, sp: NMSparse, impl: Impl = "auto",
              plan_o: Optional[int] = None, ring_impl: Impl = "auto"
              ) -> torch.Tensor:
    """Y = x @ W_sp.T (layer orientation). x [..., K], sp dense_shape [O, K].

    ``plan_o``: the whole weight's O when ``sp`` holds a shard of its rows;
    the kernels then launch under the whole shape's plan.  Under
    ``impl="ring"`` ``sp`` is this rank's shard of the rows and the result
    is the whole [..., O * ranks] (``dist.collectives.ring_sparse_linear``;
    each step's product takes ``ring_impl``, 'auto' being the decode
    kernel on the card and the plain path on the CPU); without a mesh of
    more than one rank the ring is the local product."""
    n, m = sp.n, sp.m
    if impl == "auto":
        impl = "xwt" if x.is_cuda else "plain"
    if impl == "ring":
        inner = ring_impl if ring_impl != "auto" else (
            "spmv" if x.is_cuda else "plain")
        mesh = ring_mesh()
        if mesh is None:
            return nm_matmul(x, sp, inner, plan_o)
        from repro_torch.dist.collectives import ring_sparse_linear
        return ring_sparse_linear(x, sp.values, sp.indices, n, m, mesh,
                                  inner, plan_o)
    if impl == "ref":
        lead = x.shape[:-1]
        y = kref.nm_xwt_ref(x.reshape(-1, x.shape[-1]), sp.values,
                            sp.indices, n, m)
        return y.reshape(*lead, -1)
    if impl == "plain":
        return _xwt_plain(x, sp.values, sp.indices, n, m)
    if impl == "xwt":
        return kops.nm_xwt(x, sp.values, sp.indices, n, m, plan_o=plan_o)
    if impl in ("spmv", "spmv_onehot"):
        return kops.nm_spmv(x, sp.values, sp.indices, n, m,
                            mode="onehot" if impl == "spmv_onehot"
                            else "gather", plan_o=plan_o)
    raise ValueError(f"unknown impl {impl!r} (one of auto, ref, plain, "
                     f"xwt, spmv, spmv_onehot, ring)")


class _SteSparsify(torch.autograd.Function):
    """Forward ``w * mask``; backward the straight-through dense gradient
    plus the SR-STE decay ``lam * (1 - mask) * w`` on the pruned entries,
    cast to w's dtype (the reference's ``custom_vjp``).  The mask is kept
    for the backward as booleans."""

    @staticmethod
    def forward(ctx, w, n, m, lam):
        mask = nm_mask(w, n, m)
        ctx.save_for_backward(w, mask)
        ctx.lam = lam
        return w * mask.to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        w, mask = ctx.saved_tensors
        with torch.autograd.profiler.record_function("ste_sparsify.bwd"):
            decay = (ctx.lam * ((1.0 - mask.to(w.dtype)) * w)).to(g.dtype)
            return (g + decay).to(w.dtype), None, None, None


def ste_sparsify(w: torch.Tensor, n: int, m: int, lam: float) -> torch.Tensor:
    """N:M-sparsified view of ``w`` [..., out, in] with SR-STE gradients."""
    with torch.autograd.profiler.record_function("ste_sparsify.fwd"):
        return _SteSparsify.apply(w, n, m, lam)


def nm_matmul_ste(x: torch.Tensor, w: torch.Tensor, n: int, m: int,
                  lam: float) -> torch.Tensor:
    """y = x @ sparsify(w).T with straight-through training semantics,
    accumulated in f32, result in x's dtype."""
    return matmul_f32acc(x, ste_sparsify(w, n, m, lam))


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """The fixed-mask product (ASP-style fine-tuning): autograd gives the
    masked gradient."""
    return matmul_f32acc(x, w * mask.to(w.dtype))


def dense_forward_view(w: torch.Tensor, sp: SparsityConfig,
                       mask: Optional[torch.Tensor] = None,
                       out_dim: Optional[int] = None) -> torch.Tensor:
    """Dense view [..., out, in] of a dense-stored weight with the forward
    semantics ``linear_apply`` uses: a stored ``mask`` (the 'fixed' mode)
    applies; 'srste' recomputes the N:M mask with straight-through
    gradients; a not yet converted 'compressed' policy applies the
    magnitude mask (never silently unmasked).  Shared by the MoE stacked
    products and the MLA absorbed decode, so those paths cannot diverge
    from the per-linear one.  ``out_dim`` is the whole weight's rows when
    ``w`` is a shard of them (the policy decides on the whole weight)."""
    if not sp.applies(w.shape[-1], out_dim or w.shape[-2]):
        return w
    if mask is not None:
        return w * mask.to(w.dtype)
    if sp.mode == "srste":
        return ste_sparsify(w, sp.n, sp.m, sp.srste_lam)
    if sp.mode == "compressed":
        return w * nm_mask(w, sp.n, sp.m).to(w.dtype)
    return w
