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

Training adds collectives with backward passes (module ``Function``s),
over a ``dist.api.AxisGroup`` of the training mesh:

  * ``all_gather`` / ``all_gather_last``: the backward keeps this rank's
    slice of the cotangent (every rank's downstream is the same, so the
    cotangent is whole on every rank);
  * ``reduce_grad``: the identity forward, an all-reduce (sum) of the
    cotangent backward, on the input of a product over this rank's rows
    (each rank's dX is its rows' part of the sum);
  * ``split_last``: this rank's part of a whole feature axis, the
    cotangent all-gathered backward;
  * ``fsdp_gather``: a parameter's shard all-gathered along its FSDP
    dimension; backward the gradient reduce-scattered (sum, in f32) back
    to the shard and all-reduced over the batch axes the leaf is
    replicated on (``fsdp_reduce``, the same, without autograd).

Plus ``all_reduce`` (floats sum in f32 on the wire: gloo carries no bf16
on some builds), ``all_to_all`` and the point-to-point ``send_recv``.
On an abstract mesh (``dist.api.make_abstract_mesh``, whose groups are
``dist.api.ABSTRACT``) each of them counts what it would send and returns
an uninitialised result of the right shape, with no transport call.
Their counters are ``fsdp_gather_bytes`` / ``fsdp_scatter_bytes``,
``reduce_bytes``, ``a2a_bytes`` and ``p2p_bytes``: the bytes this rank
puts on the wire under the ring algorithms, all-gather and reduce-scatter
(n - 1) shards, all-reduce 2 (n - 1) / n of the tensor, all-to-all
(n - 1) / n of its buffer.  A group of one (``group`` None) moves
nothing and counts nothing.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sparsity import (index_bits, pack_indices_i32,
                                       unpack_indices)
from repro_torch.launch.op_cost import uncounted


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor (a view of a contiguous
    copy)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _unwire(t: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The inverse of ``_wire`` over the last axis of ``t``."""
    return t.view(dtype).reshape(*t.shape[:-1], *shape)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host_empty(shape, dtype: torch.dtype, mesh) -> torch.Tensor:
    """An uninitialised host buffer, pinned when the mesh stages: the
    caching host allocator reuses it, and the copies to and from the card
    run as DMA (a fresh pageable buffer faults in every page)."""
    return torch.empty(shape, dtype=dtype, pin_memory=mesh.staged)


def _to_host(t: torch.Tensor, mesh) -> torch.Tensor:
    if not mesh.staged:
        return t
    mesh.stats["staged_bytes"] += _nbytes(t)
    out = _host_empty(t.shape, t.dtype, mesh)
    out.copy_(t)
    return out


def _to_device(t: torch.Tensor, mesh) -> torch.Tensor:
    if not mesh.staged:
        return t
    mesh.stats["staged_bytes"] += _nbytes(t)
    return t.to(mesh.device)


def _count(mesh, key: str, nbytes: int) -> None:
    mesh.stats[key] = mesh.stats.get(key, 0) + int(nbytes)


def _abstract(mesh) -> bool:
    from repro_torch.dist.api import ABSTRACT
    return mesh.group is ABSTRACT


def _grad_needed(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: [n, *x.shape]; the
    backward keeps this rank's slice of the cotangent."""
    if _grad_needed(x):
        return _AllGather.apply(x, mesh)
    return _all_gather(x, mesh)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rank = mesh.rank
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


@uncounted
def _all_gather(x: torch.Tensor, mesh, key: str = "gather_bytes"
                ) -> torch.Tensor:
    import torch.distributed as dist
    if mesh.group is None:
        return x.unsqueeze(0)
    n = mesh.size
    if _abstract(mesh):
        _count(mesh, key, _nbytes(x) * (n - 1))
        return x.new_empty((n,) + tuple(x.shape))
    w = _wire(_to_host(x.contiguous(), mesh))
    if mesh.backend == "nccl":
        out = torch.empty((n,) + tuple(w.shape), dtype=w.dtype,
                          device=w.device)
        dist.all_gather_into_tensor(out, w, group=mesh.group)
    else:
        out = _host_empty((n,) + tuple(w.shape), w.dtype, mesh)
        dist.all_gather(list(out.unbind(0)), w, group=mesh.group)
    _count(mesh, key, _nbytes(w) * (n - 1))
    return _to_device(_unwire(out, x.dtype, x.shape), mesh)


def all_gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every rank's ``x`` [..., c] along the last axis, rank
    order: [..., n * c], the whole feature axis of a row-sharded output."""
    g = all_gather(x, mesh)
    return g.movedim(0, -2).reshape(*x.shape[:-1], mesh.size * x.shape[-1])


@uncounted
def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """The elementwise sum (``op="max"``: maximum) of every rank's ``x``,
    in ``x``'s dtype; a float travels and sums as f32, an integer as
    itself.  No autograd."""
    import torch.distributed as dist
    if mesh.group is None:
        return x
    w = x.float() if x.is_floating_point() else x
    if _abstract(mesh):
        _count(mesh, "reduce_bytes",
               2 * (mesh.size - 1) * _nbytes(w) // mesh.size)
        return torch.empty_like(x)
    w = _to_host(w, mesh) if mesh.staged else w.contiguous().clone()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    dist.all_reduce(w, op=ops[op], group=mesh.group)
    _count(mesh, "reduce_bytes", 2 * (mesh.size - 1) * _nbytes(w) // mesh.size)
    return _to_device(w, mesh).to(x.dtype)


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh), None


def reduce_grad(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` itself; in the backward its cotangent summed over ``mesh``."""
    if mesh.group is None or not _grad_needed(x):
        return x
    return _ReduceGrad.apply(x, mesh)


class _SplitLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        part = y.shape[-1] // mesh.size
        return y.narrow(-1, mesh.rank * part, part)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.mesh), None


def split_last(y: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's 1/n of ``y``'s last axis, whose cotangent is
    all-gathered back to the whole axis."""
    if _grad_needed(y):
        return _SplitLast.apply(y, mesh)
    part = y.shape[-1] // mesh.size
    return y.narrow(-1, mesh.rank * part, part)


def _gather_last(x, mesh):
    g = _all_gather(x, mesh)
    return g.movedim(0, -2).reshape(*x.shape[:-1], mesh.size * x.shape[-1])


def gather_dim(x: torch.Tensor, mesh, dim: int,
               key: str = "fsdp_gather_bytes") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (no
    autograd)."""
    if mesh is None or mesh.group is None:
        return x
    return torch.cat(list(_all_gather(x, mesh, key)), dim=dim)


@uncounted
def reduce_scatter_dim(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The sum over ``mesh`` of every rank's ``x``, of which this rank
    keeps its 1/n along ``dim`` (the part ``gather_dim`` takes from it),
    summed in f32, in f32."""
    import torch.distributed as dist
    if mesh is None or mesh.group is None:
        return x
    n = mesh.size
    part = x.shape[dim] // n
    if _abstract(mesh):
        out = x.new_empty((*x.shape[:dim], part, *x.shape[dim + 1:]),
                          dtype=torch.float32)
        _count(mesh, "fsdp_scatter_bytes", _nbytes(out) * (n - 1))
        return out
    chunks = x.float().reshape(*x.shape[:dim], n, part, *x.shape[dim + 1:]) \
        .movedim(dim, 0).contiguous()
    w = _to_host(chunks, mesh)
    out = _host_empty(w.shape[1:], w.dtype, mesh) if mesh.staged else \
        torch.empty(w.shape[1:], dtype=w.dtype, device=w.device)
    if not _NO_RS.get(mesh.backend):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                dist.reduce_scatter_tensor(out.view(-1), w.view(-1),
                                           group=mesh.group)
        except (RuntimeError, NotImplementedError):
            # a build without it raises before it sends anything, on every
            # rank alike; the all-reduce below computes the same sum
            _NO_RS[mesh.backend] = True
    if _NO_RS.get(mesh.backend):
        dist.all_reduce(w, group=mesh.group)
        out = w[mesh.rank].clone()
    _count(mesh, "fsdp_scatter_bytes", _nbytes(out) * (n - 1))
    return _to_device(out, mesh)


_NO_RS: Dict[str, bool] = {}     # backends found without reduce-scatter


def fsdp_reduce(g: torch.Tensor, split, dim: Optional[int], rest
                ) -> torch.Tensor:
    """A whole-leaf gradient ``g`` -> this rank's shard of its sum over the
    batch ranks: reduce-scattered over ``split`` along ``dim`` (f32), then
    all-reduced over ``rest``, the batch axes the leaf is replicated on.
    Identity (``g`` itself) when both are groups of one."""
    if split is not None and split.group is not None:
        g = reduce_scatter_dim(g, split, dim)
    if rest is not None and rest.group is not None:
        g = all_reduce(g, rest)
    return g


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, split, dim, rest):
        ctx.args = (split, dim, rest)
        return gather_dim(shard, split, dim)

    @staticmethod
    def backward(ctx, g):
        split, dim, rest = ctx.args
        out = fsdp_reduce(g, split, dim, rest)
        return out.to(g.dtype), None, None, None


def fsdp_gather(shard: torch.Tensor, split, dim: Optional[int], rest
                ) -> torch.Tensor:
    """A parameter's whole leaf (over the data axes) from this rank's
    shard: all-gathered over ``split`` along ``dim``; its gradient comes
    back through ``fsdp_reduce``."""
    idle = ((split is None or split.group is None)
            and (rest is None or rest.group is None))
    if idle or not _grad_needed(shard):
        return shard if idle else gather_dim(shard, split, dim)
    return _FSDPGather.apply(shard, split, dim, rest)


@uncounted
def all_to_all(tensors: Sequence[torch.Tensor], mesh
               ) -> List[torch.Tensor]:
    """Each of ``tensors`` [n, ...]: slot d goes to rank d; returns the
    same shapes, whose slot s came from rank s (the reference's
    ``lax.all_to_all(x, axis, 0, 0)``), all in one exchange: each
    destination's slots of every tensor travel as one run of bytes.  No
    autograd."""
    import torch.distributed as dist
    if mesh.group is None:
        return list(tensors)
    n = mesh.size
    if _abstract(mesh):
        _count(mesh, "a2a_bytes",
               sum(_nbytes(t) for t in tensors) * (n - 1) // n)
        return [torch.empty_like(t) for t in tensors]
    rows = [_wire(_to_host(t.contiguous(), mesh)).reshape(n, -1)
            for t in tensors]
    w = torch.cat(rows, dim=1)
    out = _host_empty(w.shape, w.dtype, mesh) if mesh.staged else \
        torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group)
    _count(mesh, "a2a_bytes", _nbytes(w) * (n - 1) // n)
    got, at = [], 0
    for t, r in zip(tensors, rows):
        part = out[:, at:at + r.shape[1]].contiguous()
        got.append(_to_device(_unwire(part, t.dtype, t.shape[1:]), mesh))
        at += r.shape[1]
    return got


def send_recv(x: torch.Tensor, mesh) -> torch.Tensor:
    """Point to point: send ``x`` to rank + 1 while receiving the same
    shape from rank - 1 (the reference's ``ppermute`` over a ring);
    counted in ``p2p_bytes``.  No autograd."""
    if mesh.group is None:
        return x
    (y,) = RingShift([x], mesh, key="p2p_bytes").wait()
    return y


class RingShift:
    """One ring step started: ``tensors`` go to rank + 1 while the same
    number arrive from rank - 1; ``wait()`` returns what arrived.  Started
    before the step's product and waited on after it, so the transfer
    overlaps the compute (under NCCL; gloo's sends complete on the host)."""

    @uncounted
    def __init__(self, tensors: Sequence[torch.Tensor], mesh,
                 key: str = "ring_bytes"):
        import torch.distributed as dist
        self.mesh = mesh
        self.kinds = [(t.dtype, t.shape) for t in tensors]
        if _abstract(mesh):
            self.like = [torch.empty_like(t) for t in tensors]
            _count(mesh, key, sum(_nbytes(t) for t in tensors))
            return
        n, r = mesh.size, mesh.rank
        dst = dist.get_global_rank(mesh.group, (r + 1) % n)
        src = dist.get_global_rank(mesh.group, (r - 1) % n)
        sends = [_wire(_to_host(t.contiguous(), mesh)) for t in tensors]
        self.recvs = [_host_empty(s.shape, s.dtype, mesh) if mesh.staged
                      else torch.empty_like(s) for s in sends]
        ops = ([dist.P2POp(dist.isend, s, dst, mesh.group) for s in sends]
               + [dist.P2POp(dist.irecv, v, src, mesh.group)
                  for v in self.recvs])
        self.reqs = dist.batch_isend_irecv(ops)
        _count(mesh, key, sum(_nbytes(s) for s in sends))

    @uncounted
    def wait(self) -> List[torch.Tensor]:
        if _abstract(self.mesh):
            return self.like
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
