"""Collectives of tensor-parallel serving (counterpart of
``repro.dist.collectives``).

``collective_matmul_ag`` and ``collective_matmul_ag_sparse`` are the
reference's ring matmuls over ``torch.distributed`` point-to-point sends
(``batch_isend_irecv``): each step multiplies the shard a rank holds while
the next one is on its way from the ring neighbour.  The sparse one is the
paper's compressed format at cluster scale: what rotates is a rank's
*compressed* N:M shard, its values plus its indices packed into
ceil(log2 M)-bit words (``core.sparsity.pack_indices_i32``); each rank
unpacks on arrival and runs the port's own N:M product on the shard it
holds (``core.sparse_matmul.nm_matmul``: the decode kernel on the card,
the plain path on the CPU).  Every rank computes every shard's rows with
the same contraction order as one device would, so the result is whole
on every rank and bit-equal to the local product.  ``ring_step_bytes`` /
``ring_matmul_bytes`` are the reference's traffic model.

The transport (``all_gather``, ``all_gather_last``, ``RingShift``) counts
what it sends in the mesh's ``stats``: ``ring_bytes`` (the ring's sends),
``gather_bytes`` (an all-gather's sends to the other ranks) and, under
gloo on a card, ``staged_bytes`` (device bytes copied through host
buffers, both ways).  Every tensor moves as its bytes (a flat uint8
view: every backend takes uint8, and no backend rounds a float it
carries).  A failed collective raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sparsity import (index_bits, pack_indices_i32,
                                       unpack_indices)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor (a view of a contiguous
    copy)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _unwire(t: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The inverse of ``_wire`` over the last axis of ``t``."""
    return t.view(dtype).reshape(*t.shape[:-1], *shape)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_host(t: torch.Tensor, mesh) -> torch.Tensor:
    if not mesh.staged:
        return t
    mesh.stats["staged_bytes"] += _nbytes(t)
    return t.cpu()


def _to_device(t: torch.Tensor, mesh) -> torch.Tensor:
    if not mesh.staged:
        return t
    mesh.stats["staged_bytes"] += _nbytes(t)
    return t.to(mesh.device)


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: [n, *x.shape]."""
    import torch.distributed as dist
    n = mesh.size
    w = _wire(_to_host(x.contiguous(), mesh))
    if mesh.backend == "nccl":
        out = torch.empty((n,) + tuple(w.shape), dtype=w.dtype,
                          device=w.device)
        dist.all_gather_into_tensor(out, w, group=mesh.group)
    else:
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=mesh.group)
        out = torch.stack(parts)
    mesh.stats["gather_bytes"] += _nbytes(w) * (n - 1)
    return _to_device(_unwire(out, x.dtype, x.shape), mesh)


def all_gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every rank's ``x`` [..., c] along the last axis, rank
    order: [..., n * c], the whole feature axis of a row-sharded output."""
    g = all_gather(x, mesh)
    return g.movedim(0, -2).reshape(*x.shape[:-1], mesh.size * x.shape[-1])


class RingShift:
    """One ring step started: ``tensors`` go to rank + 1 while the same
    number arrive from rank - 1; ``wait()`` returns what arrived.  Started
    before the step's product and waited on after it, so the transfer
    overlaps the compute (under NCCL; gloo's sends complete on the host)."""

    def __init__(self, tensors: Sequence[torch.Tensor], mesh):
        import torch.distributed as dist
        self.mesh = mesh
        self.kinds = [(t.dtype, t.shape) for t in tensors]
        n, r = mesh.size, mesh.rank
        dst = dist.get_global_rank(mesh.group, (r + 1) % n)
        src = dist.get_global_rank(mesh.group, (r - 1) % n)
        sends = [_wire(_to_host(t.contiguous(), mesh)) for t in tensors]
        self.recvs = [torch.empty_like(s) for s in sends]
        ops = ([dist.P2POp(dist.isend, s, dst, mesh.group) for s in sends]
               + [dist.P2POp(dist.irecv, v, src, mesh.group)
                  for v in self.recvs])
        self.reqs = dist.batch_isend_irecv(ops)
        mesh.stats["ring_bytes"] += sum(_nbytes(s) for s in sends)

    def wait(self) -> List[torch.Tensor]:
        for req in self.reqs:
            req.wait()
        return [_to_device(_unwire(v, dt, shape), self.mesh)
                for v, (dt, shape) in zip(self.recvs, self.kinds)]


def collective_matmul_ag(x: torch.Tensor, w: torch.Tensor, mesh
                         ) -> torch.Tensor:
    """y_local = x_full @ w_local without gathering x.

    Per rank (mesh of n): x [B, K/n], this rank's shard of the contraction
    axis; w [K, O/n], the whole contraction axis of the local output
    columns.  Returns y [B, O/n].  Each of the n steps multiplies the held
    x shard by the matching K rows of w and passes the shard one hop."""
    n, r = mesh.size, mesh.rank
    chunk = x.shape[-1]
    acc = torch.zeros((x.shape[0], w.shape[-1]),
                      dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    xb = x
    for i in range(n):
        shift = RingShift([xb], mesh) if i != n - 1 else None
        src = (r - i) % n                 # origin rank of the held shard
        acc = acc + xb @ w[src * chunk:(src + 1) * chunk]
        if shift is not None:
            (xb,) = shift.wait()
    return acc


def collective_matmul_ag_sparse(values: torch.Tensor, indices: torch.Tensor,
                                x: torch.Tensor, mesh, n: int, m: int,
                                impl: str = "auto",
                                plan_o: Optional[int] = None
                                ) -> torch.Tensor:
    """y = x @ decompress(W_sp).T with only compressed shards on the wire.

    Per rank (mesh of ndev): values [O/ndev, K/M*N] and int8 indices of
    this rank's output rows, x [B, K] replicated.  Returns y [B, O], the
    same on every rank: every shard passes through every rank.  What
    rotates is the values and the bit-packed index words; each rank
    unpacks on arrival and runs ``nm_matmul(impl)`` on the shard it holds
    (``plan_o``: the whole O, whose launch plan the shard's launch takes).
    Step i's product overlaps step i + 1's transfer."""
    from repro_torch.core.sparse_matmul import nm_matmul
    from repro_torch.core.sparsity import NMSparse
    ndev, r = mesh.size, mesh.rank
    o_shard, nnz = values.shape
    k = x.shape[-1]
    outs: List[Optional[torch.Tensor]] = [None] * ndev
    vb, wb, ib = values, pack_indices_i32(indices, m), indices
    for i in range(ndev):
        shift = RingShift([vb, wb], mesh) if i != ndev - 1 else None
        src = (r - i) % ndev
        outs[src] = nm_matmul(x, NMSparse(vb, ib, n, m, (o_shard, k)), impl,
                              plan_o=plan_o)
        if shift is not None:
            vb, wb = shift.wait()
            ib = unpack_indices(wb, m, nnz)
    return torch.cat(outs, dim=-1)


def ring_step_bytes(o_shard: int, k: int, n: int = 2, m: int = 4, *,
                    dtype_bytes: int = 2, sparse: bool = True,
                    packed: bool = True) -> Dict[str, int]:
    """Bytes one rank sends per ring step: o_shard * K dense values, or the
    compressed o_shard * (K / M) * N values plus the ceil(log2 M)-bit index
    stream (``packed``) or int8 indices."""
    if not sparse:
        dense = o_shard * k * dtype_bytes
        return dict(value_bytes=dense, index_bytes=0, total_bytes=dense)
    nnz = o_shard * (k // m) * n
    value_bytes = nnz * dtype_bytes
    if packed:
        index_bytes = int(np.ceil(nnz * index_bits(m) / 8))
    else:
        index_bytes = nnz               # int8 stream
    return dict(value_bytes=value_bytes, index_bytes=index_bytes,
                total_bytes=value_bytes + index_bytes)


def ring_matmul_bytes(o: int, k: int, ndev: int, n: int = 2, m: int = 4, *,
                      dtype_bytes: int = 2, sparse: bool = True,
                      packed: bool = True) -> int:
    """Bytes of one whole ring matmul (every rank, every step): each rank
    passes its held shard on ndev - 1 times.  ``sparse=False`` models the
    same ring shipping dense weights."""
    per_step = ring_step_bytes(o // ndev, k, n, m, dtype_bytes=dtype_bytes,
                               sparse=sparse, packed=packed)["total_bytes"]
    return ndev * (ndev - 1) * per_step


def ring_sparse_linear(x: torch.Tensor, values: torch.Tensor,
                       indices: torch.Tensor, n: int, m: int, mesh,
                       impl: str = "auto", plan_o: Optional[int] = None
                       ) -> torch.Tensor:
    """y = x @ decompress(values, indices).T through the sparse ring:
    values / indices are this rank's shard [O/ndev, nnz] of the output
    rows, x [..., K] replicated; returns the whole y [..., O] in x's dtype
    on every rank, bit-equal to the local product of the whole weight
    (every rank multiplies each shard in the same contraction order)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = collective_matmul_ag_sparse(values, indices, x2, mesh, n, m, impl,
                                    plan_o)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)
