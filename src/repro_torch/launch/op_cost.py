"""Op-level cost counter of one eager step (the port's stand-in for
``repro.launch.hlo_cost``).

The reference parses compiled HLO text and weights each op by the trip
count of its enclosing loops.  Eager PyTorch has no HLO: every iteration
of a Python loop dispatches its own ops.  So ``OpCost`` is a
``TorchDispatchMode`` that counts the aten ops of a step as they run, on
``meta``, CPU or CUDA tensors, and returns the keys of ``analyze_hlo``:

  flops      — 2 * prod(out) * prod(contracted) of every matrix product
               and convolution (``torch.utils.flop_counter``'s formulas)
  bytes      — the bytes of each op's tensor inputs and outputs.  Views,
               ``empty`` and metadata ops move nothing; an op reads a
               slice of a stacked buffer at the slice's size (a view is
               its own numel), a gather (``index_select`` / ``gather`` /
               ``embedding``) its source at the result's size; an
               in-place update counts its update: ``copy_`` the source
               read and written, an indexed write (``index_put_``,
               ``scatter_``, ...) twice its values and indices, ``fill_``
               / ``zero_`` the target written once
  collective — the bytes the step's collectives put on the wire, by
               type: the deltas of the mesh's transport counters
               (``dist.collectives``; a ring algorithm's sends, on an
               abstract mesh the sends the real one would make), not the
               reference's result-buffer bytes.  A collective's own ops
               (wire views, staging, its buffers) count nothing
               (``uncounted``), so a real mesh and an abstract one count
               the same bytes
  loops      — always {}: eager code runs each iteration

Kernel regions: the port's CUDA kernels are ``ctypes`` calls that a
dispatch mode never sees.  Each launcher wrapper (the N:M product
``core.sparse_matmul.nm_matmul``, ``kernels.nm_spmm.nm_spmm``, the
paged attention and flash attention wrappers) opens ``region`` around
its work, on its kernel and on its plain version alike.  Inside a region
no aten op is counted; the wrapper adds its call once with a model of
its work (``add``): dense-equivalent FLOPs, and bytes as the least
traffic (each operand once, a compressed weight at its stored size).  So
a step counts the same FLOPs and bytes through the kernels as on the
plain path.  A region inside a region counts nothing (a ring step's
product inside the ring's ``nm_matmul``).  The backward of a region runs
outside it and is counted by its own ops.

``temp_size_in_bytes`` is an estimate: the peak of the bytes held by
the tensors the step's ops create, each released when its Python object
dies.
"""

from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

# a mesh counter -> the collective type it counts
_STAT_TYPES = {
    "gather_bytes": "all-gather",
    "fsdp_gather_bytes": "all-gather",
    "fsdp_scatter_bytes": "reduce-scatter",
    "reduce_bytes": "all-reduce",
    "a2a_bytes": "all-to-all",
    "ring_bytes": "collective-permute",
    "p2p_bytes": "collective-permute",
}

# ops with no memory traffic of their own
_NO_BYTES = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
    aten._local_scalar_dense, aten.is_same_size, aten.sym_size,
    aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
}
# reads its first input at the result's size
_GATHERS = {aten.index_select, aten.gather, aten.embedding, aten.index}
_WRITE_ONLY = {aten.fill_, aten.zero_, aten.normal_, aten.uniform_,
               aten.random_, aten.bernoulli_, aten.exponential_}

_STACK = []          # the active counters, innermost last


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Region:
    """A kernel wrapper's region (module docstring)."""

    __slots__ = ("cost", "name", "outer")

    def __init__(self, cost: Optional["OpCost"], name: str):
        self.cost, self.name, self.outer = cost, name, False

    def __enter__(self) -> "_Region":
        if self.cost is not None:
            self.outer = self.cost._depth == 0
            self.cost._depth += 1
        return self

    def __exit__(self, *exc) -> None:
        if self.cost is not None:
            self.cost._depth -= 1

    def add(self, flops: float, nbytes: float) -> None:
        """Count this call once: ``flops`` and ``nbytes`` of its model
        (nothing when a region encloses this one or no counter runs)."""
        if self.outer:
            c = self.cost
            c.flops += float(flops)
            c.bytes += float(nbytes)
            c.op_counts[self.name] += 1
            c.regions[self.name] += 1


def region(name: str) -> _Region:
    """A kernel wrapper's region, named after its kernel: a no-op when no
    ``OpCost`` is counting in this thread."""
    return _Region(_STACK[-1] if _STACK else None, name)


def counted(name: str, cost):
    """Decorate a kernel wrapper: while an ``OpCost`` counts, its call runs
    in ``region(name)`` and adds ``cost(out, *args, **kwargs)`` -> (FLOPs,
    bytes) once; otherwise it is called as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _STACK:
                return fn(*args, **kwargs)
            with region(name) as r:
                out = fn(*args, **kwargs)
                if r.outer:
                    r.add(*cost(out, *args, **kwargs))
            return out
        return inner
    return wrap


def uncounted(fn):
    """Decorate a collective's transport: while an ``OpCost`` counts, its
    aten ops (wire views, staging copies, the result buffers) count
    nothing; what it sends counts as collective bytes."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        if not _STACK:
            return fn(*args, **kwargs)
        with _Region(_STACK[-1], ""):
            return fn(*args, **kwargs)
    return inner


def operand_bytes(*ts) -> int:
    """The bytes of each tensor of ``ts`` once (None skipped)."""
    return sum(_nbytes(t) for t in ts if isinstance(t, torch.Tensor))


class OpCost(TorchDispatchMode):
    """Counts the aten ops run while it is active (module docstring).
    ``mesh``: whose transport counters give the collective bytes (default:
    the mesh of the active ``dist.api.axis_rules`` at entry).
    ``record_ops``: keep (op name, bytes) of every counted op, the
    dry-run's ``--save-hlo`` listing."""

    def __init__(self, mesh=None, record_ops: bool = False):
        super().__init__()
        self.mesh = mesh
        self.flops = 0.0
        self.bytes = 0.0
        self.op_counts: Dict[str, int] = defaultdict(int)
        self.regions: Dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self.ops = [] if record_ops else None
        self._depth = 0
        self._stats0: Dict[str, int] = {}

    def __enter__(self):
        if self.mesh is None:
            from repro_torch.dist.api import current_mesh
            self.mesh = current_mesh()
        self._stats0 = dict(self.mesh.stats) if self.mesh is not None else {}
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        return super().__exit__(*exc)

    # ---------------------------------------------------------- counting

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        self.op_counts[name] += 1
        if packet in _FLOPS:
            self.flops += _FLOPS[packet](*args, **kwargs, out_val=out)
        b = self._bytes(func, packet, args, kwargs, out)
        self.bytes += b
        if self.ops is not None and b:
            self.ops.append((name, b))
        return out

    def _bytes(self, func, packet, args, kwargs, out) -> int:
        schema = func._schema
        rets = schema.returns
        if packet in _NO_BYTES or (
                rets and rets[0].alias_info is not None
                and not rets[0].alias_info.is_write):
            return 0                                   # a view or metadata
        written = [a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        named = dict(zip((a.name for a in schema.arguments), args))
        named.update(kwargs)
        if written and "out" not in written:           # in place
            targets = {id(named[n]) for n in written
                       if isinstance(named.get(n), torch.Tensor)}
            target = sum(_nbytes(named[n]) for n in written
                         if isinstance(named.get(n), torch.Tensor))
            others = sum(_nbytes(t) for t in _tensors((args, kwargs))
                         if id(t) not in targets)
            if packet in _WRITE_ONLY:
                return target
            if packet is aten.copy_:
                return others + target
            if any(k in packet.__name__ for k in ("index", "scatter",
                                                  "put")):
                return 2 * others
            return 2 * target + others
        ins = _tensors((args, {k: v for k, v in kwargs.items()
                               if k != "out"}))
        outs = _tensors(out)
        total = sum(_nbytes(t) for t in outs)
        if packet in _GATHERS and ins:
            total += min(_nbytes(ins[0]), total) + sum(
                _nbytes(t) for t in ins[1:])
        else:
            total += sum(_nbytes(t) for t in ins)
        if not written:
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return total

    # ------------------------------------------------------------ results

    def collectives(self) -> Dict[str, float]:
        """Wire bytes of the step's collectives by type."""
        out: Dict[str, float] = defaultdict(float)
        if self.mesh is None:
            return {}
        for key, kind in _STAT_TYPES.items():
            d = self.mesh.stats.get(key, 0) - self._stats0.get(key, 0)
            if d:
                out[kind] += float(d)
        return dict(out)

    def result(self) -> Dict[str, Any]:
        """The keys of the reference's ``analyze_hlo``."""
        coll = self.collectives()
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": float(sum(coll.values())),
                "collectives_by_type": coll,
                "op_counts": dict(self.op_counts),
                "loops": {}}


def _flop_table():
    from torch.utils.flop_counter import flop_registry
    return {k: v for k, v in flop_registry.items()
            if isinstance(k, torch._ops.OpOverloadPacket)}


_FLOPS = _flop_table()
