"""Expert-parallel MoE dispatch over all-to-all (counterpart of
``repro.dist.moe_a2a``).

Each rank owns E / n experts and T / n tokens.  Dispatch routes every
token's top-K copies to the ranks owning the chosen experts through one
all-to-all of a fixed-capacity buffer (the copies' rows and their local
expert ids travel in the same exchange; the token stream is never
all-gathered), the expert FFN runs on the rank's own experts, and a
second all-to-all returns the results to each token's home rank for the
gate-weighted combine.

Buffer layout: ``sbuf[d, p]`` is the p-th token copy this rank sends to
rank d; the all-to-all keeps (sender, slot) addressing, so the combine
reads results back by the same (dest, slot) pairs it scattered with.
Like the reference, no model calls it: it is a library function, held to
the dense per-token route by the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.collectives import all_to_all


def moe_a2a_local(x: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
                  wu: torch.Tensor, wd: torch.Tensor, mesh, n_experts: int,
                  top_k: int, *, cap_per_pair: int) -> torch.Tensor:
    """This rank's part of the expert-parallel MoE layer over ``mesh`` (an
    ``AxisGroup`` of n ranks; rank r owns experts [r E/n, (r+1) E/n)).

      x:      [Tl, D]           local tokens
      router: [E, D]            replicated routing weights
      wg/wu:  [E/n, DFF, D]     local experts' gate / up projections
      wd:     [E/n, D, DFF]     local experts' down projection

    Returns y [Tl, D] in x's dtype.  ``cap_per_pair`` bounds the copies
    any rank sends any other; copies past it are dropped (their gate
    weight is lost, the capacity-dropping semantics).  The products
    accumulate in f32, the expert FFN is silu-gated."""
    n = mesh.size
    e_local = n_experts // n
    tl, d = x.shape
    cap = cap_per_pair
    dev = x.device

    # ---- route (the dense route's math, on the local tokens) ------------
    probs = torch.softmax(x.float() @ router.float().t(), dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :top_k], ids[:, :top_k]
    gate = gate / gate.sum(-1, keepdim=True)

    # ---- scatter token copies into the per-destination send buffer ------
    ids_f = ids.reshape(-1)
    gate_f = gate.reshape(-1)
    tok_f = torch.arange(tl, device=dev).repeat_interleave(top_k)
    dest_f = ids_f // e_local
    elid_f = (ids_f % e_local).to(torch.int32)
    onehot = F.one_hot(dest_f, n)
    pos_f = (torch.cumsum(onehot, 0) - onehot).gather(1, dest_f[:, None])[:, 0]
    keep = pos_f < cap
    sbuf = x.new_zeros((n, cap, d))
    sbuf[dest_f[keep], pos_f[keep]] = x[tok_f[keep]]
    ebuf = torch.full((n, cap), -1, dtype=torch.int32, device=dev)
    ebuf[dest_f[keep], pos_f[keep]] = elid_f[keep]

    # ---- dispatch: rbuf[s, p] = slot p sent by rank s -------------------
    rbuf, relid = all_to_all([sbuf, ebuf], mesh)

    # ---- local expert FFN on each received copy, its own expert only ----
    xt = rbuf.reshape(n * cap, d).float()
    el = relid.reshape(n * cap)
    y_tok = torch.zeros((n * cap, d), dtype=torch.float32, device=dev)
    for e in range(e_local):
        rows = torch.nonzero(el == e)[:, 0]
        if rows.numel() == 0:
            continue
        xe = xt[rows]
        h = F.silu(xe @ wg[e].float().t()) * (xe @ wu[e].float().t())
        y_tok[rows] = h @ wd[e].float().t()

    # ---- return trip + gate-weighted combine at the token's home --------
    (back,) = all_to_all([y_tok.reshape(n, cap, d).to(x.dtype)], mesh)
    contrib = back[dest_f, pos_f.clamp(max=cap - 1)].float()
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    y = torch.zeros((tl, d), dtype=torch.float32, device=dev).index_add_(
        0, tok_f, gate_f[:, None] * contrib)
    return y.to(x.dtype)


def a2a_bytes(n: int, cap_per_pair: int, d: int, dtype_bytes: int) -> int:
    """Bytes one rank sends in ``moe_a2a_local``'s two exchanges: (n - 1)
    of its n destination slots of the dispatch (rows plus int32 expert
    ids) and of the return (rows)."""
    slot = cap_per_pair * d * dtype_bytes
    return (n - 1) * (slot + cap_per_pair * 4) + (n - 1) * slot
