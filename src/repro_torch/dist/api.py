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
"""

from __future__ import annotations

import dataclasses
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


def require_mesh(what: str) -> ServeMesh:
    """The active mesh, or a ``RuntimeError`` naming ``what``: a sharded
    tensor used outside its mesh never runs as if it were whole."""
    mesh = _active.mesh
    if mesh is None:
        raise RuntimeError(f"{what} is sharded over a serving mesh; run it "
                           f"inside that mesh's axis_rules context")
    return mesh


def local_part(name: str, size: int) -> Optional[Tuple[int, int]]:
    """``(parts, index)`` when a dimension of ``size`` named logically
    ``name`` is split over the active mesh's "model" axis (this rank holds
    part ``index`` of ``parts``), else None: no mesh, or the rule or the
    divisibility pass leaves it whole."""
    mesh = _active.mesh
    if mesh is None:
        return None
    spec = logical_to_pspec((name,), _active.rules, mesh=mesh, shape=(size,))
    if not spec:
        return None
    return mesh.shape["model"], mesh.rank


# ------------------------------------------------------------------ shardings

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A resolved spec on a mesh: ``spec`` the reference's entries, and
    calling it on a whole tensor returns this rank's shard (a contiguous
    copy; a replicated tensor comes back as it is)."""
    spec: Tuple
    mesh: Any

    def _axes(self):
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            if names != ("model",):
                raise ValueError(f"the serving mesh has one 'model' axis; "
                                 f"spec {self.spec} names {names}")
            yield dim

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for dim in self._axes():
            out[dim] //= self.mesh.shape["model"]
        return tuple(out)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        dims = list(self._axes())
        if not dims:
            return t
        n, r = self.mesh.shape["model"], self.mesh.rank
        for dim in dims:
            part = t.shape[dim] // n
            t = t.narrow(dim, r * part, part)
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
