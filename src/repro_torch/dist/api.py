"""Logical-axis sharding for the port: rules, context, the serving mesh
(counterpart of ``repro.dist.api``).

Model code names tensor axes *logically* ("tp", "act_heads", ...); a rule
table maps each logical name to a tuple of physical mesh axes.  The
tables and ``logical_to_pspec`` are the reference's, entry for entry, with
its two safety passes:

  * axis-reuse dedupe: a mesh axis shards at most one dimension of a
    tensor; a later logical name loses an axis already claimed;
  * divisibility: with the tensor's shape known, a mesh axis that does not
    evenly divide its dimension is dropped (the dimension replicates).

The reference hands the resolved specs to GSPMD.  The port has no
partitioner, so the layout is explicit: ``make_shardings`` turns a spec
tree into ``Sharding`` objects that cut a whole tensor to this rank's
shard, ``models.transformer.shard_model`` cuts a model with them, and the
model code asks ``local_part`` whether an axis it is about to use is
sharded under the active ``axis_rules`` context.

The serving mesh is one axis, "model", over the ranks of a
``torch.distributed`` process group (``make_serve_mesh``): one process per
rank, each driving one device.  ``ServeMesh`` carries the group, this
rank, its device, the backend and the transport's byte counters
(``dist.collectives``).  NCCL moves device tensors itself; gloo moves host
tensors, so on a card the transport stages through host buffers and counts
those bytes too.  The backend is the caller's choice and is never switched
in silence.

The training mesh (``make_train_mesh``, ``TrainMesh``) has the axes
("data", "model"), or ("pod", "data", "model"), over the whole group in
row-major rank order (the last axis fastest).  It carries one process
group per row, column and (for three axes) slab of the mesh, created in
one fixed order on every rank (gloo deadlocks otherwise); ``axis(*names)``
is the ``AxisGroup`` of this rank over a subset of the axes, which the
collectives take.  Model code reads only the "model" axis
(``require_mesh`` / ``local_part``); the trainer reads the batch axes
(``batch_axis``: the axes the rules map ``act_batch`` to).  A serving
mesh is its own "model" axis.

The abstract mesh (``make_abstract_mesh``) is a ``TrainMesh`` of any
axis sizes whose groups are the ``ABSTRACT`` marker, not process groups:
this process is its rank 0 and its device is ``meta``.  Under it each
collective of ``dist.collectives`` counts the bytes the real one would
put on the wire and returns a ``meta`` result of the right shape, with
no ``torch.distributed`` call: the dry-run's stand-in for a 256- or
512-card mesh.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import socket
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

# ----------------------------------------------------------------- rule tables
#
# Values are tuples of physical mesh axis names (None = replicated), the
# reference's tables.

DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    # weight axes
    "tp": ("model",),          # tensor-parallel (output-feature) axis
    "fsdp": ("data",),         # fully-sharded weight axis (gathered on use)
    "ep": ("data",),           # stacked expert axis of MoE weights
    # activation axes
    "act_batch": ("data",),
    "act_seq": None,           # sequence replicated by default
    "act_seq_sp": ("model",),  # sequence-parallel regions borrow the TP axis
    "act_heads": ("model",),
    "act_vocab": ("model",),
    "act_ep": ("data",),       # expert-capacity buffers follow the expert axis
}

# Multi-pod: the leading "pod" axis carries cross-pod data parallelism.
MULTIPOD_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    **DEFAULT_RULES,
    "act_batch": ("pod", "data"),
}

# Serving: tensor-parallel only.  Weight output-feature axes and per-head
# activation / KV axes split over "model"; block tables, positions, scalars
# and expert stacks replicate.  No contraction axis is ever split, which is
# what keeps the single-device engine a valid token-equality oracle.
SERVE_TP_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "tp": ("model",),
    "fsdp": None,
    "ep": None,
    "act_batch": None,
    "act_seq": None,
    "act_seq_sp": None,
    "act_heads": ("model",),
    "act_vocab": ("model",),
    "act_ep": None,
}


def default_rules_for(mesh) -> Dict[str, Optional[Tuple[str, ...]]]:
    return MULTIPOD_RULES if "pod" in mesh.shape else DEFAULT_RULES


def train_rules_for(cfg, mesh) -> Dict[str, Optional[Tuple[str, ...]]]:
    """The training rules of ``cfg`` on ``mesh``: ``default_rules_for``,
    or under ``cfg.train_layout == "fulldp"`` the reference dry-run's
    full data parallelism (weights replicated, the batch over every axis
    of the mesh)."""
    rules = dict(default_rules_for(mesh))
    if cfg.train_layout == "fulldp":
        rules.update(act_batch=(("pod", "data", "model") if "pod" in
                                mesh.shape else ("data", "model")),
                     fsdp=None, tp=None, act_heads=None, act_vocab=None,
                     act_seq_sp=None, act_ep=None)
    return rules


# ---------------------------------------------------------------- the mesh

@dataclasses.dataclass
class ServeMesh:
    """The serving mesh: one "model" axis over the ranks of ``group``.
    ``stats`` are this rank's transport counters (``dist.collectives``):
    ``ring_bytes`` the bytes the ring sent, ``gather_bytes`` the bytes
    all-gathers sent, ``staged_bytes`` the device bytes copied through host
    buffers under gloo."""
    size: int
    rank: int
    device: torch.device
    backend: str
    group: Any = None
    stats: Dict[str, int] = dataclasses.field(default_factory=lambda: {
        "ring_bytes": 0, "gather_bytes": 0, "staged_bytes": 0})

    axis_names = ("model",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"model": self.size}

    @property
    def staged(self) -> bool:
        """Whether collectives stage device tensors through the host."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def reset_stats(self) -> None:
        for key in self.stats:
            self.stats[key] = 0

    def coord(self, axis: str) -> int:
        if axis != "model":
            raise ValueError(f"the serving mesh has one 'model' axis, not "
                             f"{axis!r}")
        return self.rank

    def axis(self, *names: str):
        """This mesh over ``names``: itself for "model", a group of one
        for no axis."""
        names = tuple(n for n in names if n in self.shape)
        if names == ("model",):
            return self
        return AxisGroup(1, 0, self.device, self.backend, None, self.stats)


# The transport's counters of a training mesh (``dist.collectives``):
# the serving ones, the FSDP gathers and reduce-scatters, all-reduces,
# all-to-alls and point-to-point sends, in bytes this rank puts on the
# wire (a ring collective's sends).
TRAIN_STATS = ("ring_bytes", "gather_bytes", "staged_bytes",
               "fsdp_gather_bytes", "fsdp_scatter_bytes", "reduce_bytes",
               "a2a_bytes", "p2p_bytes")


@dataclasses.dataclass
class AxisGroup:
    """This rank over some axes of a mesh: ``size`` ranks, this one at
    ``rank`` (row-major over the axes), ``group`` their process group
    (None for a group of one, whose collectives are the identity); the
    counters are the mesh's own."""
    size: int
    rank: int
    device: torch.device
    backend: str
    group: Any
    stats: Dict[str, int]

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"


@dataclasses.dataclass
class TrainMesh:
    """The training mesh (module docstring): ``names`` and ``sizes`` of its
    axes, this process's ``rank`` in the group, its device and backend,
    ``groups`` {axis subset: this rank's process group over it} and the
    transport's counters."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[Tuple[str, ...], Any]
    stats: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(TRAIN_STATS, 0))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def coord(self, axis: str) -> int:
        i = self.names.index(axis)
        return (self.rank // math.prod(self.sizes[i + 1:])) % self.sizes[i]

    def axis(self, *names: str) -> AxisGroup:
        """This rank's ``AxisGroup`` over ``names`` (in the mesh's order;
        axes the mesh lacks are left out)."""
        names = tuple(n for n in self.names if n in names)
        size, index = 1, 0
        for n in names:
            size, index = size * self.shape[n], index * self.shape[n] \
                + self.coord(n)
        return AxisGroup(size, index, self.device, self.backend,
                         self.groups.get(names) if size > 1 else None,
                         self.stats)

    def reset_stats(self) -> None:
        for key in self.stats:
            self.stats[key] = 0


class _Abstract:
    """The process group of every axis of an abstract mesh."""

    def __repr__(self) -> str:
        return "ABSTRACT"


ABSTRACT = _Abstract()


def make_abstract_mesh(shape: Sequence[int],
                       names: Optional[Sequence[str]] = None) -> TrainMesh:
    """A ``TrainMesh`` of ``shape`` over the axes ``names`` (default
    ("data", "model"), or ("pod", "data", "model") for three) with no
    process group: rank 0, device ``meta``, every group ``ABSTRACT``
    (module docstring).  Nothing is started or allocated."""
    shape = tuple(int(n) for n in shape)
    names = tuple(names) if names is not None else (
        ("data", "model") if len(shape) == 2 else ("pod", "data", "model"))
    if len(names) != len(shape) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} over axes {names}")
    groups = {tuple(names[i] for i in sub): ABSTRACT
              for k in range(1, len(names) + 1)
              for sub in itertools.combinations(range(len(names)), k)
              if math.prod(shape[i] for i in sub) > 1}
    return TrainMesh(names, shape, 0, torch.device("meta"), "abstract",
                     groups)


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_serve_mesh(tp: Optional[int] = None, backend: Optional[str] = None,
                    devices: Optional[Sequence] = None,
                    device="cuda") -> ServeMesh:
    """The 1-D ("model",) serving mesh over this process group.

    With ``torch.distributed`` already initialised (``--distributed``,
    torchrun, or the CLI's own ``--tp N`` spawn), the mesh spans the whole
    group: ``tp`` must be None or its world size, and ``backend``, when
    given, must be the group's.  Without a group, a mesh of one rank
    starts one (``backend``: NCCL on the card, gloo on the CPU) on a free
    localhost port; a wider mesh raises, since it needs its other
    processes.  Rank r drives ``devices[r]`` when given, else
    ``cuda:{r % device_count}`` (``device="cpu"``: the CPU).  Two NCCL
    ranks on one card raise here, before NCCL would."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_serve_mesh: a CUDA mesh was asked for but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for the plain path over gloo")
    if not dist.is_initialized():
        if tp not in (None, 1):
            raise ValueError(
                f"tp={tp} needs {tp} processes in one torch.distributed "
                f"group; start them with `python -m repro_torch.launch.serve "
                f"--tp {tp}`, or torchrun and --distributed")
        backend = backend or _default_backend(dev)
        _check_nccl(backend, 1, dev)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0)
    world, rank = dist.get_world_size(), dist.get_rank()
    tp = tp or world
    if tp != world:
        raise ValueError(f"tp={tp} but the process group has {world} ranks; "
                         f"the serving mesh spans the whole group")
    actual = dist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"backend {backend!r} asked for, but the process "
                         f"group runs {actual!r}")
    if devices is not None:
        local = torch.device(devices[rank])
    elif dev.type == "cuda":
        local = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        local = dev
    _check_nccl(actual, world, local)
    if local.type == "cuda":
        torch.cuda.set_device(local)
    mesh = ServeMesh(size=world, rank=rank, device=local, backend=actual,
                     group=dist.group.WORLD)
    if actual == "nccl":
        # create the communicator now, eagerly: a CUDA graph can capture
        # NCCL collectives only over a communicator that already exists
        probe = torch.ones(1, device=local)
        dist.all_reduce(probe)
        torch.cuda.synchronize(local)
    return mesh


def make_train_mesh(shape: Sequence[int], backend: Optional[str] = None,
                    device="cuda", names: Optional[Sequence[str]] = None
                    ) -> TrainMesh:
    """The training mesh of ``shape`` (data, model), or (pod, data, model),
    over this process group, whose world size must be the mesh's.  Without
    a group, a mesh of one starts one, as ``make_serve_mesh`` does.  Every
    rank builds the sub-groups here in one order.  Rank r drives
    ``cuda:{r % device_count}`` (the CPU under ``device="cpu"``)."""
    import torch.distributed as dist
    shape = tuple(int(n) for n in shape)
    names = tuple(names) if names is not None else (
        ("data", "model") if len(shape) == 2 else ("pod", "data", "model"))
    if len(names) != len(shape) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} over axes {names}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_train_mesh: a CUDA mesh was asked for but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for the plain path over gloo")
    world = math.prod(shape)
    if not dist.is_initialized():
        if world != 1:
            raise ValueError(
                f"a {shape} mesh needs {world} processes in one "
                f"torch.distributed group; start them with `python -m "
                f"repro_torch.launch.train --mesh --ranks {world}`, or "
                f"torchrun and --distributed")
        backend = backend or _default_backend(dev)
        _check_nccl(backend, 1, dev)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0)
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} has {world} ranks "
                         f"but the process group {dist.get_world_size()}")
    rank, actual = dist.get_rank(), dist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"backend {backend!r} asked for, but the process "
                         f"group runs {actual!r}")
    if dev.type == "cuda":
        local = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        local = dev
    _check_nccl(actual, world, local)
    if local.type == "cuda":
        torch.cuda.set_device(local)
    coords = list(itertools.product(*(range(n) for n in shape)))
    groups: Dict[Tuple[str, ...], Any] = {}
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(range(len(names)), k):
            if math.prod(shape[i] for i in sub) == 1:
                continue
            key = tuple(names[i] for i in sub)
            if math.prod(shape[i] for i in sub) == world:
                groups[key] = dist.group.WORLD
                continue
            rest = [i for i in range(len(names)) if i not in sub]
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                ranks = [r for r, c in enumerate(coords)
                         if all(c[i] == f for i, f in zip(rest, fixed))]
                g = dist.new_group(ranks)     # every rank, in this order
                if rank in ranks:
                    groups[key] = g
    return TrainMesh(names, shape, rank, local, actual, groups)


def _check_nccl(backend: str, world: int, device: torch.device) -> None:
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError("the NCCL backend moves device tensors; a CPU mesh "
                         "takes backend='gloo'")
    if world > torch.cuda.device_count():
        raise ValueError(
            f"NCCL cannot put two ranks of one communicator on one card: "
            f"{world} ranks over {torch.cuda.device_count()} visible "
            f"device(s); use backend='gloo' (staged through host memory) to "
            f"run several ranks on one card")


def init_from_env(backend: str, coordinator: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> None:
    """Join a process group started elsewhere: from the coordinator flags
    (``host:port``, world size, rank), else from the torchrun environment
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``)."""
    import torch.distributed as dist
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        return
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                           "RANK") if k not in os.environ]
    if missing:
        raise ValueError(f"--distributed without --coordinator reads the "
                         f"torchrun environment; {', '.join(missing)} unset")
    dist.init_process_group(backend, init_method="env://")


# ----------------------------------------------------------------- resolution

def _rule_axes(name: Optional[str], rules: Dict[str, Any]) -> Tuple[str, ...]:
    """Physical axes for one logical name (tolerates str/None rule values)."""
    if name is None:
        return ()
    axes = rules.get(name)
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def logical_to_pspec(spec: Sequence[Optional[str]], rules: Dict[str, Any],
                     mesh=None, shape: Optional[Sequence[int]] = None
                     ) -> Tuple:
    """Logical spec tuple -> the resolved entries (the reference's
    ``PartitionSpec`` as a tuple: None, an axis name, or a tuple of them;
    no trailing None), with dedupe and divisibility.  ``mesh`` (anything
    with a ``.shape`` dict) filters out axes it does not have and gives
    axis sizes for the divisibility check, which ``shape`` turns on."""
    used: set = set()
    entries = []
    for i, name in enumerate(spec):
        kept = []
        shards = 1
        for ax in _rule_axes(name, rules):
            if ax in used:
                continue                        # axis-reuse dedupe
            if mesh is not None and ax not in mesh.shape:
                continue
            if shape is not None and mesh is not None and i < len(shape):
                if shape[i] % (shards * mesh.shape[ax]) != 0:
                    continue                    # non-dividing axis -> dropped
            kept.append(ax)
            used.add(ax)
            if mesh is not None:
                shards *= mesh.shape[ax]
        if not kept:
            entries.append(None)
        elif len(kept) == 1:
            entries.append(kept[0])
        else:
            entries.append(tuple(kept))
    while entries and entries[-1] is None:   # canonical form: no trailing None
        entries.pop()
    return tuple(entries)


# -------------------------------------------------------------------- context

class _Active(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules = None


_active = _Active()


@contextmanager
def axis_rules(mesh, rules: Optional[Dict[str, Any]] = None):
    """Activate (mesh, rules) in this thread: the model's sharded paths
    read them (``local_part``, the collectives).  ``rules`` defaults to
    DEFAULT_RULES, or MULTIPOD_RULES when the mesh has a "pod" axis.
    Nestable; the previous binding is restored on exit."""
    prev = (_active.mesh, _active.rules)
    _active.mesh = mesh
    _active.rules = dict(rules if rules is not None
                         else default_rules_for(mesh))
    try:
        yield mesh
    finally:
        _active.mesh, _active.rules = prev


def current_mesh():
    return _active.mesh


def current_rules():
    return _active.rules


def require_mesh(what: str):
    """The active mesh's "model" axis (a serving mesh is its own), or a
    ``RuntimeError`` naming ``what``: a sharded tensor used outside its
    mesh never runs as if it were whole."""
    mesh = _active.mesh
    if mesh is None:
        raise RuntimeError(f"{what} is sharded over a mesh; run it "
                           f"inside that mesh's axis_rules context")
    return mesh.axis("model")


def model_axis():
    """The active mesh's "model" axis when it has more than one rank, else
    None."""
    mesh = _active.mesh
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh.axis("model")


def batch_axes() -> Tuple[str, ...]:
    """The mesh axes of more than one rank that the active rules split the
    batch over (``act_batch``), in the mesh's order; () without a mesh."""
    mesh = _active.mesh
    if mesh is None:
        return ()
    axes = _rule_axes("act_batch", _active.rules)
    return tuple(a for a in mesh.axis_names
                 if a in axes and mesh.shape[a] > 1)


def batch_axis() -> Optional["AxisGroup"]:
    """This rank's group over ``batch_axes()``, None when the batch is
    whole: the group whose ranks hold the parts of one global batch."""
    axes = batch_axes()
    return _active.mesh.axis(*axes) if axes else None


def local_part(name: str, size: int) -> Optional[Tuple[int, int]]:
    """``(parts, index)`` when a dimension of ``size`` named logically
    ``name`` is split over the active mesh's "model" axis (this rank holds
    part ``index`` of ``parts``), else None: no mesh, or the rule or the
    divisibility pass leaves it whole."""
    mesh = _active.mesh
    if mesh is None:
        return None
    spec = logical_to_pspec((name,), _active.rules, mesh=mesh, shape=(size,))
    if spec != ("model",):
        return None
    return mesh.shape["model"], mesh.coord("model")


# ------------------------------------------------------------------ shardings

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A resolved spec on a mesh: ``spec`` the reference's entries, and
    calling it on a whole tensor returns this rank's shard (a contiguous
    copy; a replicated tensor comes back as it is).  A dimension split
    over several axes is cut row-major over them (the first axis
    slowest), the order the all-gathers over ``mesh.axis(*names)`` undo."""
    spec: Tuple
    mesh: Any

    def axes(self):
        """(dim, axis names) of every split dimension."""
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            for name in names:
                if name not in self.mesh.shape:
                    raise ValueError(f"spec {self.spec} names {name!r}, "
                                     f"which the mesh "
                                     f"{tuple(self.mesh.shape)} lacks")
            yield dim, names

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for dim, names in self.axes():
            out[dim] //= math.prod(self.mesh.shape[n] for n in names)
        return tuple(out)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        cuts = list(self.axes())
        if not cuts:
            return t
        for dim, names in cuts:
            parts, index = 1, 0
            for n in names:
                parts *= self.mesh.shape[n]
                index = index * self.mesh.shape[n] + self.mesh.coord(n)
            part = t.shape[dim] // parts
            t = t.narrow(dim, index * part, part)
        return t.contiguous().clone()


def _is_spec_leaf(leaf) -> bool:
    return leaf is None or (
        isinstance(leaf, tuple)
        and all(e is None or isinstance(e, str) for e in leaf))


def make_shardings(specs, mesh=None, rules: Optional[Dict[str, Any]] = None,
                   shapes_tree=None):
    """Logical-spec tree (nested dicts; a leaf is a tuple of logical names
    or None, replicated) -> a tree of ``Sharding``s of the same structure.
    ``shapes_tree`` (tensors or shapes, same structure) turns on the
    divisibility pass, so an uneven dimension replicates."""
    mesh = mesh if mesh is not None else _active.mesh
    if mesh is None:
        raise ValueError("make_shardings needs a mesh (argument or active "
                         "axis_rules context)")
    if rules is None:
        rules = (_active.rules if _active.rules is not None
                 else default_rules_for(mesh))

    def one(spec, shape=None):
        if spec is None:
            return Sharding((), mesh)
        return Sharding(logical_to_pspec(spec, rules, mesh=mesh, shape=shape),
                        mesh)

    def walk(s, x):
        if _is_spec_leaf(s):
            shape = None if x is None else tuple(getattr(x, "shape", x))
            return one(s, shape)
        return {k: walk(v, None if x is None else x[k]) for k, v in s.items()}

    return walk(specs, shapes_tree)
