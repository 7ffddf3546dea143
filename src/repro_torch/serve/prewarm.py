"""Cold start for the serve engine: the CUDA-graphed entry points, their
prewarm, and the capture accounting (counterpart of
``repro.serve.prewarm``).

The reference jits each engine entry point (decode, prefill per bucket,
propose, verify) and AOT-compiles the closed shape set before the first
admission, so a steady tick is one executable.  On the card the
counterpart of an XLA executable is a CUDA graph: a tick run eagerly is
some 500 small host calls per llama3.2-1b forward, and the card idles
while the host issues them.  This module holds what the engine needs to
replace them by one graph replay:

* ``GraphEntry`` wraps one entry point.  Per shape key it holds static
  input buffers on the device; on the card (``graphs=True``) it runs one
  eager warm-up on a side stream (every host sync in it raises, through
  ``torch.cuda.set_sync_debug_mode("error")``), then captures the function
  into a ``torch.cuda.CUDAGraph`` from the engine's one memory pool.  A
  call copies its per-call arguments into the static buffers and replays;
  the call that builds a shape is its own warm-up and returns the
  warm-up's results, so it runs once (an abstract prewarm warms up on
  zeros).
  Tensors the function reads and writes in place (the engine's KV pools)
  are captured by address: every replay checks that their ``data_ptr()``s
  are still the captured ones and raises if one moved.  Without graphs
  (the CPU, or ``graphs=False`` on the card: the eager oracle) the same
  shape keys and static-buffer copies run and the function is called
  directly.
* ``CompileLog`` / ``CompileEvent``: every graph captured (every shape
  key built, without graphs) is an event tagged ``prewarm``, ``init`` or
  ``serve``; ``strict=True`` turns a ``serve`` event (a mid-serve capture)
  into an error.
* Launch accounting: a kernel launched while a graph is captured is not
  a launch (``kernels.build.capture_launches``); the entry records what
  each graph captured, and every replay adds it to the launchers' counts.
  The same holds for the transport's byte counters (``counters=``, the
  mesh's ``stats``): a capture sends nothing, so what it counted is taken
  back and added again at every replay.
* Tensor-parallel serving: an engine over an NCCL mesh captures its
  collectives (all-gathers, the ring's sends and receives) into the
  graphs like any kernel; the mesh warms the communicator up at creation,
  before any capture.  gloo's collectives stage through host memory,
  which no graph can hold, so an engine over gloo on the card runs its
  entry points eagerly (``graphs=True`` raises there); its
  ``executable_shapes()`` is the same set either way.
* ``abstract_batch``: the [1, L] prefill inputs of one bucket, built by the
  same ``batch_prompt`` that admission uses, so the prewarmed shapes are
  the admitted ones by construction.
* ``enable_compile_cache``: what persists across processes here is the
  kernel build directory (``kernels.build.BUILD_DIR``): a cold bring-up
  runs nvcc, a warm one loads the libraries.  Graphs do not persist.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.serve.request import synthetic_request

CACHE_ENV_VAR = "REPRO_COMPILE_CACHE"


def enable_compile_cache(path=None) -> str:
    """Point the kernel build (``kernels.build``) at a directory that
    persists across processes and return its absolute path.  ``path``
    resolution: an explicit directory wins; ``True`` / ``"auto"`` /
    ``None`` fall back to ``$REPRO_COMPILE_CACHE`` and then to the
    package's own build directory.  Raises if a kernel library was already
    loaded from another directory in this process."""
    if path in (None, True, "", "auto"):
        path = os.environ.get(CACHE_ENV_VAR) or build.DEFAULT_BUILD_DIR
    return str(build.set_build_dir(path))


@dataclasses.dataclass
class CompileEvent:
    """One executable built: a CUDA graph captured (or, without graphs, a
    shape key's static buffers set up), where, when and what it cost.

    ``phase`` is ``"prewarm"`` (``prewarm()`` at engine init), ``"init"`` (a
    lazy capture before the engine started serving) or ``"serve"`` (a lazy
    capture inside the serving loop, the cold-start bill prewarm removes).
    ``seconds`` is warm-up + capture wall time; ``trace_seconds`` the eager
    warm-up's share (0.0 without graphs)."""

    entry: str
    label: str
    phase: str
    seconds: float
    trace_seconds: float = 0.0


class CompileLog:
    """Engine-wide ledger of capture events across every entry point.

    ``serving`` flips to True when the engine finishes init / prewarm; an
    event after that is a mid-serve capture, and with ``strict`` it
    raises."""

    def __init__(self, strict: bool = False):
        self.events: List[CompileEvent] = []
        self.serving = False
        self.strict = strict

    def record(self, ev: CompileEvent) -> None:
        self.events.append(ev)
        if ev.phase == "serve" and self.strict:
            raise RuntimeError(
                f"mid-serve compile of {ev.entry}[{ev.label}] "
                f"({ev.seconds:.3f}s) — the prewarmed executable set does "
                f"not cover this shape; extend "
                f"ServeEngine.executable_shapes()/prewarm() or serve "
                f"without strict_prewarm")

    @property
    def mid_serve_compiles(self) -> int:
        return sum(1 for e in self.events if e.phase == "serve")

    @property
    def prewarm_compiles(self) -> int:
        return sum(1 for e in self.events if e.phase == "prewarm")

    @property
    def compile_seconds(self) -> float:
        return sum(e.seconds for e in self.events)


def _flatten(tree) -> Tuple[List[torch.Tensor], object]:
    """Leaves of a tree of tensors (dicts taken in sorted key order, tuples
    and lists in order) and its structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                ("dict", tuple(keys), tuple(p[1] for p in parts)))
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t) for t in tree]
        return ([leaf for p in parts for leaf in p[0]],
                (type(tree).__name__, len(tree), tuple(p[1] for p in parts)))
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"entry arguments are tensors, got {type(tree)}")
    return [tree], "leaf"


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build_(s):
        if s == "leaf":
            return next(it)
        kind, what, subs = s
        parts = [build_(sub) for sub in subs]
        if kind == "dict":
            return dict(zip(what, parts))
        return tuple(parts) if kind == "tuple" else list(parts)
    return build_(spec)


def _shape_key(args) -> Tuple:
    """Dispatch key of a call: tree structure + per-leaf (shape, dtype).
    The same for concrete tensors and for abstract (``meta``) ones, and
    independent of dict insertion order."""
    leaves, spec = _flatten(args)
    return spec, tuple((tuple(leaf.shape), leaf.dtype) for leaf in leaves)


def _describe(args, limit: int = 5) -> str:
    leaves, _ = _flatten(args)
    return ",".join(f"{str(leaf.dtype).replace('torch.', '')}"
                    f"{list(leaf.shape)}" for leaf in leaves[-limit:])


def abstract(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """An abstract entry argument: shape and dtype, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@contextlib.contextmanager
def _sync_debug_error():
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


class _Executable:
    """One shape key of an entry: static inputs and, on the card, the
    captured graph, its outputs, the launches it holds, the transport
    bytes a replay sends and the addresses of the tensors it captured."""

    def __init__(self, spec, static: List[torch.Tensor]):
        self.spec = spec
        self.static = static
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.launches: Dict[object, int] = {}
        self.sent: Dict[str, int] = {}
        self.ptrs: Tuple[int, ...] = ()


class GraphEntry:
    """One engine entry point, captured as a CUDA graph per shape key.

    ``fn(*args)`` takes the per-call arguments (a tree of tensors: the
    engine's token ids, positions, block tables, prompt batches) and
    returns a tree of tensors; whatever else it reads or writes (weights,
    KV pools) it closes over.  ``fixed()`` lists the tensors the graphs
    capture by address that the engine may touch between replays (the KV
    pools); a replay raises if one has moved.  ``graphs`` captures on the
    card; without it every call copies into the static buffers and calls
    ``fn`` directly.  ``pool`` / ``stream``: the engine's one graph memory
    pool and its side stream (warm-up and capture run there).
    ``counters``: byte counters the function adds to as it runs (the
    serving mesh's transport ``stats``); a replay adds what its capture
    counted.

    ``capture(*args, label=)`` builds a shape key ahead of time (args may
    be abstract); ``__call__`` dispatches.  ``n_compiles`` counts shape keys
    built, ``warm_calls`` calls that built nothing, ``calls`` every call.
    The returned tensors are the graph's static outputs: read them before
    the next call of the same entry.  Every call and capture runs under
    ``torch.no_grad()``: a served model whose parameters were trained
    (``requires_grad``) records no autograd graph."""

    def __init__(self, name: str, fn: Callable, *, device: torch.device,
                 graphs: bool, log: Optional[CompileLog] = None, pool=None,
                 stream=None, fixed: Callable[[], List[torch.Tensor]] = list,
                 counters: Optional[Dict[str, int]] = None):
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.name = name
        self.fn = fn
        self.device = device
        self.graphs = graphs
        self.log = log if log is not None else CompileLog()
        self.pool = pool
        self.stream = stream
        self.fixed = fixed
        self.counters = counters if counters is not None else {}
        self._exe: Dict[Tuple, _Executable] = {}
        self.n_compiles = 0
        self.warm_calls = 0
        self.calls = 0

    @torch.no_grad()
    def capture(self, *args, label: str = "") -> bool:
        """Build ``args``'s shape key ahead of time; False when it is
        already built."""
        key = _shape_key(args)
        if key in self._exe:
            return False
        self._build(key, args, label or _describe(args), "prewarm")
        return True

    @torch.no_grad()
    def __call__(self, *args):
        key = _shape_key(args)
        exe = self._exe.get(key)
        self.calls += 1
        if exe is None:
            exe, out = self._build(key, args, _describe(args),
                                   "serve" if self.log.serving else "init")
            if exe.graph is not None:
                # the call ran once, in the capture's warm-up on its own
                # arguments: a replay now would run it a second time
                leaves, spec = _flatten(out)
                return _unflatten(spec, [t.clone() for t in leaves])
        else:
            self.warm_calls += 1
        leaves, _ = _flatten(args)
        for buf, leaf in zip(exe.static, leaves):
            buf.copy_(leaf, non_blocking=True)
        if exe.graph is None:
            return self.fn(*_unflatten(exe.spec, exe.static))
        ptrs = tuple(t.data_ptr() for t in self.fixed())
        if ptrs != exe.ptrs:
            raise RuntimeError(
                f"{self.name}: a tensor captured by address has moved since "
                f"the graph was captured (pool pointers {exe.ptrs} -> "
                f"{ptrs}); the graph would read freed memory")
        exe.graph.replay()
        for kernel, n in exe.launches.items():
            kernel.launches += n
        for key, n in exe.sent.items():
            self.counters[key] += n
        return exe.out

    def _build(self, key, args, label: str, phase: str):
        """Build ``args``'s shape key -> (executable, the warm-up's
        outputs: None without graphs)."""
        leaves, spec = _flatten(args)
        static = [torch.zeros(tuple(leaf.shape), dtype=leaf.dtype,
                              device=self.device) for leaf in leaves]
        # a concrete call warms up on its own arguments (the warm-up is
        # the call): a decode over the slotted caches has no trash row, and
        # zeros would write position 0 of every live row
        for buf, leaf in zip(static, leaves):
            if leaf.device.type != "meta":
                buf.copy_(leaf)
        exe = _Executable(spec, static)
        t0 = time.perf_counter()
        warm, out = 0.0, None
        if self.graphs:
            warm, out = self._capture(exe)
        self._exe[key] = exe
        self.n_compiles += 1
        self.log.record(CompileEvent(
            entry=self.name, label=label, phase=phase,
            seconds=time.perf_counter() - t0, trace_seconds=warm))
        return exe, out

    def _capture(self, exe: _Executable):
        """Warm up on the side stream (static inputs hold the call's
        arguments, or zeros for an abstract prewarm: token 0 at position 0,
        through an all-trash table on the paged pool), then capture.
        Returns (the warm-up's seconds, its outputs)."""
        args = _unflatten(exe.spec, exe.static)
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        # the warm-up sizes every lazily grown device cache on the capture
        # stream (the split-K arrival counters, cuBLAS's workspace), so
        # nothing grows inside the capture; a host sync here raises
        with torch.cuda.stream(side), _sync_debug_error():
            out = self.fn(*args)
        side.synchronize()
        warm = time.perf_counter() - t0
        graph = torch.cuda.CUDAGraph()
        before = dict(self.counters)
        with build.capture_launches() as launched:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                exe.out = self.fn(*args)
        exe.graph = graph
        exe.launches = dict(launched)
        # the capture recorded its sends without making them
        exe.sent = {k: self.counters[k] - before[k] for k in before}
        self.counters.update(before)
        exe.ptrs = tuple(t.data_ptr() for t in self.fixed())
        return warm, out


def batch_inputs(inputs: Sequence[Dict[str, np.ndarray]]
                 ) -> Dict[str, torch.Tensor]:
    """Prompts' unbatched arrays (every input the family takes: tokens,
    embeddings, the encoder's frames) stacked into the [B, ...] host
    tensors ``prefill`` takes (token ids as int64, the rest float32)."""
    return {k: torch.from_numpy(np.stack([x[k] for x in inputs])).to(
        torch.long if k == "tokens" else torch.float32)
        for k in inputs[0]}


def batch_prompt(inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A request's unbatched prompt arrays as the [1, ...] host tensors
    ``prefill`` takes."""
    return batch_inputs([inputs])


def abstract_batch(cfg, prefill_len: int) -> Dict[str, torch.Tensor]:
    """Abstract [1, L] prefill inputs for one bucket, built from the
    family-shaped prompt builder the traces use
    (``serve.request.synthetic_request``) and batched by ``batch_prompt``,
    exactly as admission batches a real prompt: bucket-down truncates it to
    the bucket, bucket-up right-pads it, and either way the leaf is
    ``[1, bucket]``."""
    req = synthetic_request(cfg, np.random.default_rng(0), rid=-1,
                            prompt_len=prefill_len, max_new_tokens=1)
    return {k: abstract(v.shape, v.dtype)
            for k, v in batch_prompt(req.inputs).items()}
