"""FFN layers: gated MLP and Mixture-of-Experts (counterpart of
``repro.models.ffn``).

MoE uses the reference's *sort-based* capacity dispatch ("dropping" style):
assignments are sorted stably by expert id, positions past the per-expert
capacity are dropped, and dispatch and combine are row gathers through a
sentinel zero row.  Expert weights are stacked [E, out, in]
(``StackedLinear``) and N:M-sparse along ``in`` like every other
projection; the expert products are batched matmuls over their dense view,
as in the reference, so every call decompresses all E experts of a
compressed stack (reading only the routed experts' compressed bytes is
later work).

Tensor-parallel serving (``models.transformer.shard_model``): the
router's expert rows and each stack's output rows (axis -2) may be split
over the serving mesh.  The router's rows are all-gathered before routing
(E x d in f32, a few hundred KB), so every rank routes the same
replicated activations through the one-device computation to the same
experts; each stack's local product is all-gathered along its feature
axis before anything contracts over it.

Training over a mesh (``dist.api.batch_axis``: the batch split over
ranks) routes as the reference's one-program step does, over the
**global** batch: each rank's assignments take their expert-queue
positions after those of the ranks before it (the ranks' per-expert
counts are all-gathered, a few hundred bytes), the capacity is the global
batch's, and the load-balance aux uses the global counts; each rank adds
its own tokens' share of E * sum_e f_e P_e (linear in the probabilities),
so the shares sum to the unsharded aux.  Under a "model" split the
expert inputs pass ``reduce_grad`` before the row-sharded products.

Routing reproduces the reference bit for bit where it can: ``torch.topk``
promises no order among tied probabilities, so the top-k is a stable
descending sort (ties to the lower expert id, the order of
``jax.lax.top_k``), and the dispatch sort is stable too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.layers import (SparseLinear, StackedLinear, dense_view,
                                     linear_apply, linear_init)
from repro_torch.core.sparse_matmul import SparsityConfig, bmm_f32acc
from repro_torch.core.sparsity import compress
from repro_torch.dist.api import batch_axis, require_mesh
from repro_torch.dist.collectives import (all_gather, all_gather_last,
                                          reduce_grad)
from repro_torch.models.common import ACTIVATIONS
from repro_torch.models.config import ArchConfig


# ------------------------------------------------------------------ gated MLP

class MLP(nn.Module):
    def __init__(self, wg: SparseLinear, wu: SparseLinear, wd: SparseLinear):
        super().__init__()
        self.wg, self.wu, self.wd = wg, wu, wd


def mlp_init(gen: torch.Generator, cfg: ArchConfig, dtype, device="cuda",
             d_ff: Optional[int] = None) -> MLP:
    d, dff, sp = cfg.d_model, d_ff or cfg.d_ff, cfg.sparsity
    return MLP(linear_init(gen, d, dff, sp, dtype, device),
               linear_init(gen, d, dff, sp, dtype, device),
               linear_init(gen, dff, d, sp, dtype, device))


def mlp_apply(p: MLP, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    sp = cfg.sparsity
    act = ACTIVATIONS[cfg.act]
    h = act(linear_apply(p.wg, x, sp)) * linear_apply(p.wu, x, sp)
    return linear_apply(p.wd, h, sp)


# ------------------------------------------------------------------------ MoE

class MoE(nn.Module):
    """Router (an f32 [E, d] parameter, never sparsified: routing runs in
    f32; trained, as the reference's ``router.w``), the stacked expert
    weights and the optional shared-expert MLP."""

    def __init__(self, router: torch.Tensor, wg: StackedLinear,
                 wu: StackedLinear, wd: StackedLinear,
                 shared: Optional[MLP] = None):
        super().__init__()
        self.router = nn.Parameter(router.detach(), requires_grad=False)
        self.wg, self.wu, self.wd = wg, wu, wd
        self.shared = shared


_COMPRESS_ELEMS = 1 << 28      # weight elements compressed in one call


def _stacked_sparse_init(gen: torch.Generator, e: int, out_dim: int,
                         in_dim: int, sp: SparsityConfig, dtype,
                         device="cuda") -> StackedLinear:
    """Stacked expert weight [E, out, in], sparse along in; compressed at
    init under ``mode='compressed'`` (the dense stack is never kept).  The
    stack is compressed a few experts at a time: ``compress``'s rank
    temporaries are ~16x the bytes of what it is given, which for one of
    arctic-480b's stacks (128 x 4864 x 7168) would not fit the card."""
    w = torch.randn((e, out_dim, in_dim), generator=gen, device=device,
                    dtype=torch.float32).mul_(in_dim ** -0.5).to(dtype)
    if sp.applies(in_dim, out_dim) and sp.mode == "compressed":
        step = max(1, _COMPRESS_ELEMS // (out_dim * in_dim))
        parts = [compress(w[i:i + step], sp.n, sp.m) for i in range(0, e, step)]
        del w
        return StackedLinear(w_vals=torch.cat([p.values for p in parts]),
                             w_idx=torch.cat([p.indices for p in parts]))
    return StackedLinear(w=w)


def _stacked_dense_view(p: StackedLinear, sp: SparsityConfig) -> torch.Tensor:
    """Dense view [E, out, in] of stacked expert weights under any mode."""
    return dense_view(p, sp)


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype,
             device="cuda") -> MoE:
    e, d = cfg.n_experts, cfg.d_model
    dff = cfg.moe_dff or cfg.d_ff
    sp = cfg.sparsity
    router = torch.randn((e, d), generator=gen, device=device,
                         dtype=torch.float32) * d ** -0.5
    wg = _stacked_sparse_init(gen, e, dff, d, sp, dtype, device)
    wu = _stacked_sparse_init(gen, e, dff, d, sp, dtype, device)
    wd = _stacked_sparse_init(gen, e, d, dff, sp, dtype, device)
    shared = (mlp_init(gen, cfg, dtype, device,
                       d_ff=cfg.n_shared_experts * dff)
              if cfg.n_shared_experts else None)
    return MoE(router, wg, wu, wd, shared)


def _capacity(tokens: int, e: int, k: int, cf: float) -> int:
    c = int(-(-tokens * k * cf // e))
    return max(8, -(-c // 8) * 8)  # multiple of 8


def _whole(y: torch.Tensor, split) -> torch.Tensor:
    """``y``'s feature axis made whole when its rows were split."""
    return all_gather_last(y, require_mesh("a split MoE weight")) \
        if split else y


def _rows_input(x: torch.Tensor, split) -> torch.Tensor:
    """The input of a product over split rows (``reduce_grad``)."""
    return reduce_grad(x, require_mesh("a split MoE weight")) \
        if split else x


def moe_route(router: torch.Tensor, xt: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 router: xt [T, d] -> (probs [T, E], normalized gates [T, k],
    expert ids [T, k] int64).  The top-k is a stable descending sort, so
    tied probabilities go to the lower expert id as in ``jax.lax.top_k``."""
    logits = xt.float() @ router.t()
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, ids


def expert_counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert, int64 [e]: ``torch.bincount(ids,
    minlength=e)`` without its host sync (on the card bincount reads the
    ids' range back to the host, which a CUDA graph capture forbids)."""
    return torch.zeros(e, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def moe_apply(p: MoE, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux load-balance loss).  Every token of
    the call (padding and idle decode rows included) competes for expert
    capacity, exactly as in the reference."""
    b, sq, d = x.shape
    t = b * sq
    e, k = cfg.n_experts, cfg.top_k
    sp = cfg.sparsity
    act = ACTIVATIONS[cfg.act]
    group = batch_axis()            # the global batch's ranks, if split
    t_all = t * (group.size if group is not None else 1)
    cap = _capacity(t_all, e, k, cfg.capacity_factor)
    dev = x.device

    xt = x.reshape(t, d)
    router = p.router
    if getattr(p, "tp_router", None):        # this rank's experts' rows
        router = all_gather(router, require_mesh("a split router")) \
            .reshape(p.tp_router, d)
    probs, gate, ids = moe_route(router, xt, k)

    # ---- sort-based dispatch -------------------------------------------
    ids_f = ids.reshape(-1)                                   # [t*k]
    tok_f = torch.arange(t, device=dev).repeat_interleave(k)
    s_eid, s_orig = torch.sort(ids_f, stable=True)
    s_tok = tok_f[s_orig]
    counts = expert_counts(ids_f, e)                          # [e]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[s_eid]
    keep = pos < cap
    if group is not None:
        # global queue positions: the ranks before this one go first
        every = all_gather(counts, group)                     # [n, e]
        keep = pos + every[:group.rank].sum(0)[s_eid] < cap
        counts = every.sum(0)
    sentinel = e * cap
    slot = torch.where(keep, s_eid * cap + pos, torch.full_like(pos, sentinel))

    # slot -> token row (sentinel token row t = zeros)
    slot_tok = torch.full((sentinel + 1,), t, dtype=torch.long, device=dev)
    slot_tok[slot] = torch.where(keep, s_tok, torch.full_like(s_tok, t))
    xt_pad = torch.cat([xt, xt.new_zeros(1, d)])
    xbuf = xt_pad[slot_tok[:-1]].reshape(e, cap, d)

    # ---- expert FFN (batched products over the stacks' dense views) ----
    wg = _stacked_dense_view(p.wg, sp)
    wu = _stacked_dense_view(p.wu, sp)
    wd = _stacked_dense_view(p.wd, sp)
    split_gu = getattr(p.wg, "tp_rows", None)
    split_d = getattr(p.wd, "tp_rows", None)
    xin = _rows_input(xbuf, split_gu)
    h = _whole(act(bmm_f32acc(xin, wg)) * bmm_f32acc(xin, wu), split_gu)
    ybuf = _whole(bmm_f32acc(_rows_input(h, split_d), wd), split_d)
    ybuf_pad = torch.cat([ybuf.reshape(sentinel, d), ybuf.new_zeros(1, d)])

    # ---- gather-based combine (unsort; dropped -> sentinel zero row) ----
    inv = torch.zeros(t * k, dtype=torch.long, device=dev)
    inv[s_orig] = slot
    y_assign = ybuf_pad[inv].reshape(t, k, d)
    y = torch.einsum("tkd,tk->td", y_assign.float(), gate.float()).to(x.dtype)
    y = y.reshape(b, sq, d)

    if p.shared is not None:
        y = y + mlp_apply(p.shared, x, cfg)

    # GShard/Switch load-balance aux: E * sum_e f_e * P_e (a rank's share
    # of it under a batch split: its tokens' probabilities over the global
    # token count)
    f = counts.float() / max(t_all * k, 1)
    share = probs.mean(0) if group is None else probs.sum(0) / t_all
    aux = e * torch.sum(f * share)
    return y, aux
