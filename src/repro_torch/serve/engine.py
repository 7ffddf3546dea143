"""Continuous-batching serve engine over the slotted or the paged KV cache
(counterpart of ``repro.serve.engine``).

The engine owns a decode-cache pool and a per-slot position vector and
interleaves two operations:

* **prefill-on-admission** — when the scheduler places a queued request in
  a free slot, the engine prefills that request alone (batch 1) and
  installs its caches: ``kv="slotted"`` (the default, as in the reference)
  seeds a one-row cache from the prefill and writes it into the slot's row
  of the pool (``cache.scatter_slot_``, in place); ``kv="paged"`` prefills
  at a bucketed length and writes the caches into the slot's blocks
  (``BlockPool.seed``).  Token prompts bucket DOWN and
  feed the remaining prompt tokens through the batched decode step as
  *forced* tokens (exact: decode recomputes the K/V the full prefill would
  have written); a prompt shorter than the smallest bucket buckets UP with
  right padding and reads its logits at ``prompt_len - 1``.
* **batched decode** — one ``decode_step`` per tick over every slot with
  the per-slot position vector.  Slotted rows write and read their own
  row (an idle row keeps its stale token and position and writes its own
  dead row).  Paged decode reads K/V through the block table
  (``attn="fused"``: the ``paged_gqa_decode`` / ``paged_mla_decode`` kernel
  walks it in-kernel; ``"gather"``: the oracle read); idle paged rows carry
  position 0, token 0 and an all-trash table row, so they write the trash
  block.  Idle rows' logits are never read.  Every family is served; in
  the MoE family idle rows and prompt padding are tokens like any other
  and compete for expert capacity, as in the reference.  The SSM and hybrid families keep their
  recurrent state (and conv tails) slot-indexed, one row per slot in
  either layout: an idle row advances its own stale row, which admission
  overwrites.  Their token prompts still bucket down (the forced decode
  advances the state exactly), but a prompt shorter than the smallest
  bucket starts from the zero state and replays whole (``_plan``), and
  they take neither prefix hits nor ``spec=`` (the state cannot be
  shared by table or rolled back; ``ValueError``, as the reference).
  The vlm family's prompts are embeddings (``inputs["embeds"]``), which
  cannot replay through the token decode step, so they always bucket UP
  (right-padded, as the reference's).  The audio family's requests carry
  ``tokens`` and ``enc_embeds``: its prefill runs the encoder and writes
  the slot's cross K/V rows (slot-indexed state, kept whole whatever the
  bucket); its token prompts bucket down, or up below the smallest
  bucket, as the dense family's.  Neither takes a prefix hit (prefix
  sharing is keyed on token-only prompts over an all-paged pool), and
  the audio family takes no ``spec=`` (its cross K/V are slot-indexed).

The rest of this header is the paged pool's.  Blocks are appended lazily (one every ``block_size`` ticks per slot); when
the pool runs dry the newest-admitted request is preempted back to the
queue front.  ``preempt="replay"`` (the default, the oracle) replays it
from prefill on readmission (greedy decode makes the replay
deterministic); ``preempt="suspend"`` swaps its owned blocks to host
(``BlockPool.swap_out``) together with its emitted tokens, pending prompt
catch-up and position, and readmission restores all of it
(``swap_in``): preemption then costs resident bytes, not a prefill, and
no emitted token is recomputed.

``prefix_cache=True`` adds cross-request block sharing: a retiring
request registers its prompt's (token -> block) mapping in a host-side
radix trie (``serve.prefix.PrefixIndex``) that pins those blocks;
admission matches an incoming prompt against it, and a hit points the new
slot's table at the cached blocks (``BlockPool.share``): no prefill for
the shared span, and the divergent suffix replays through the decode
graph as forced tokens, like a bucketed-down prompt's catch-up.  The trie
is evicted LRU under memory pressure (before anyone is preempted); a write
into a shared block first copies it (``BlockPool.cow``), so a shared block
is never mutated.  Neither feature adds a graph shape: the copies run
eagerly between replays, on the stream the graphs replay on.

``spec=SpecConfig(k, draft, stride)`` turns on self-speculative decoding
(``serve.speculative``): each tick runs a plain decode forward for the
slots that do not speculate, then for the others k draft steps and one
k+1-wide ``verify_step``, each forward over the full pool width with the
other group's rows masked to the trash block.  Slots replaying prompt
tokens ride the verify span with those tokens as forced drafts.  Greedy
acceptance keeps the token stream of the non-speculative engine; the table
rolls back past the committed position (``BlockPool.rollback``).

Every forward runs through an entry point of ``serve.prewarm``
(``GraphEntry``): decode, prefill (one shape per bucket), and under
``spec=`` propose and verify, each returning its greedy argmax, so a tick
reads back one small int tensor.  On the card each entry captures a CUDA
graph per shape (``graphs``, the default there, as the reference's jit is
always on), and a steady tick is one graph replay plus the host's
bookkeeping; the per-call host arrays (tokens, positions, block tables,
prompts) are copied into the entry's static buffers.  ``prewarm=True``
captures the closed shape set (``executable_shapes()``) before the first
admission; a lazy engine captures a shape at first use, which counts as a
mid-serve compile (``strict_prewarm=True`` raises on one).  The slotted
engine prefills at each prompt's own length, a shape set no config bounds:
``prewarm(prompt_lens=...)`` captures the lengths a trace will bring, and
under ``strict_prewarm=True`` any other length raises.
``graphs=False`` runs every forward eagerly, the oracle (the counterpart
of the reference under ``jax.disable_jit()``); the CPU always does.
``compile_cache=`` names the kernel build directory
(``serve.prewarm.enable_compile_cache``).

``mesh=`` (a ``dist.api.ServeMesh``, ``make_serve_mesh``) turns on
tensor-parallel serving for the dense GQA and MoE / MLA families: every
rank of the mesh runs one engine, in lockstep, on the same trace (the
same deterministic scheduler; the results of every rank are the same).
The model is converted, then cut to this rank's shard under
``dist.api.SERVE_TP_RULES`` (``models.transformer.shard_model``: every
linear's output rows, the embedding's vocab, the router's experts) and
the pool to its shard of the kv heads (``BlockPool(mesh=)``,
``cache.init_local_caches``); every entry point runs inside the mesh's
``axis_rules`` context.  Only output axes are split, and activations are
whole between ops, so each element sums in the one-device order and the
single-device engine stays the token-equality oracle.
``tp_collective``: 'ring' (what 'auto' means for compressed weights)
routes every decode-shaped compressed linear through the sparse ring
(``dist.collectives.ring_sparse_linear``: the compressed shards rotate,
each rank multiplies each); 'gspmd' (the reference's name; here: the
local rows, then an all-gather) is what dense weights take.  ``stats()``
adds the modeled ring bytes of a decode step
(``models.serve_ring_traffic_bytes``) and this rank's transport counters.
With the NCCL backend the graphs capture the collectives; gloo moves host
tensors, so on a card its collectives stage through host memory, which a
graph cannot capture: the engine runs eager there, and ``graphs=True``
raises.  ``spec=`` under a mesh raises, as in the reference; the other
families raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist.api import SERVE_TP_RULES, axis_rules
from repro_torch.models import (convert_to_compressed, decode_step,
                                init_caches, make_draft, prefill,
                                serve_ring_traffic_bytes, shard_model,
                                verify_step, weight_stream_bytes)
from repro_torch.models.common import greedy_sample
from repro_torch.models.transformer import STATE_FAMILIES
from repro_torch.serve.cache import (init_local_caches, leaves,
                                     scatter_slot_, seed_decode_caches)
from repro_torch.serve.paged import (TRASH_BLOCK, BlockPool, SwapState,
                                     default_buckets)
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.prewarm import (CompileLog, GraphEntry, abstract,
                                       abstract_batch, batch_prompt,
                                       enable_compile_cache)
from repro_torch.serve.request import Request, RequestResult
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.speculative import (SpecConfig, accept_greedy,
                                           draft_propose_k)


@dataclasses.dataclass
class _SlotState:
    req: Request
    tokens: List[int]
    admitted_at: int
    # prompt tokens not yet fed (bucketed-down prefill catch-up); while
    # non-empty the slot is still consuming its prompt and emits nothing
    pending: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Suspended:
    """A suspended-to-host request: swapped cache state + runtime state."""
    state: _SlotState
    swap: SwapState
    pos: int
    tok: int


def not_ported(feature: str, slice_: str) -> NotImplementedError:
    """The error for a reference feature a later slice of the port brings."""
    return NotImplementedError(f"{feature} is not ported yet; it comes with "
                               f"the {slice_} slice of the port")


MESH_FAMILIES = ("dense", "moe")    # served over a mesh (plain token LMs)


class ServeEngine:
    """Continuous-batching greedy-decode engine on one device, or one rank
    of a tensor-parallel mesh (``mesh=``, ``tp_collective``).

    ``compressed=True`` converts the model to the compressed N:M serving
    format at init (``models.convert_to_compressed``) and serves from it.
    ``kv="slotted"`` (the default) keeps one ``max_len`` row per slot, the
    token-equality oracle; ``kv="paged"`` serves from the block pool of
    ``serve.paged``, and the rest are its options: ``block_size`` /
    ``n_blocks`` / ``prefill_buckets`` configure it; ``attn`` picks the
    paged read ('fused' kernel or 'gather' oracle); ``spec`` turns on
    self-speculative decoding; ``prefix_cache=True`` shares cached prompt
    prefixes across requests; ``preempt`` is ``"replay"`` or ``"suspend"``;
    ``debug_invariants=True`` cross-checks the block tables before every
    decode tick.  ``device`` defaults to ``cuda`` and raises when no card is
    present.

    ``graphs`` (default: on for a CUDA device) captures every entry point
    as CUDA graphs; ``graphs=True`` on the CPU raises.  ``prewarm=True``
    captures the complete ``executable_shapes()`` set at init;
    ``strict_prewarm=True`` raises on any capture inside the serving loop;
    ``compile_cache=`` (a directory, or True for the default) is where the
    kernels are built and loaded from.  ``mesh`` (a ``ServeMesh``) and
    ``tp_collective`` ('auto' | 'ring' | 'gspmd') serve this rank's shard
    of a tensor-parallel mesh (module docstring); the device is then the
    mesh's, and the model may stay on the host: only this rank's shard
    moves to the device."""

    def __init__(self, model, cfg, n_slots: int, max_len: int,
                 compressed: bool = False, kv: str = "slotted",
                 block_size: int = 4, n_blocks: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 attn: str = "gather", prefix_cache: bool = False,
                 preempt: str = "replay", debug_invariants: bool = False,
                 mesh=None, tp_collective: str = "auto",
                 spec: Optional[SpecConfig] = None,
                 compile_cache=None, prewarm: bool = False,
                 strict_prewarm: bool = False, graphs: Optional[bool] = None,
                 device="cuda"):
        t_init = time.perf_counter()
        if kv not in ("slotted", "paged"):
            raise ValueError(f"kv must be 'slotted' or 'paged', got {kv!r}")
        if attn not in ("gather", "fused"):
            raise ValueError(f"attn must be 'gather' or 'fused', got {attn!r}")
        if attn == "fused" and kv != "paged":
            raise ValueError("attn='fused' requires kv='paged' (the fused "
                             "kernel reads through the block table; the "
                             "slotted layout has none)")
        if preempt not in ("replay", "suspend"):
            raise ValueError(f"preempt must be 'replay' or 'suspend', "
                             f"got {preempt!r}")
        if prefix_cache and kv != "paged":
            raise ValueError("prefix_cache=True requires kv='paged' (prefix "
                             "hits share physical blocks through the block "
                             "table; the slotted layout has none)")
        if spec is not None and kv != "paged":
            raise ValueError("spec= requires kv='paged' (speculative "
                             "rollback rewinds the block table; the "
                             "slotted layout has none)")
        if tp_collective not in ("auto", "ring", "gspmd"):
            raise ValueError(f"tp_collective must be 'auto', 'ring' or "
                             f"'gspmd', got {tp_collective!r}")
        if mesh is not None:
            self._check_mesh(mesh, cfg, spec, device, graphs)
        if (spec is not None and spec.draft == "rerank" and not compressed
                and cfg.sparsity.mode != "compressed"):
            raise ValueError("spec.draft='rerank' re-ranks the compressed "
                             "N:M pool — serve with compressed=True (or a "
                             "model already in compressed mode)")
        self.device = resolve_device(device if mesh is None else mesh.device)
        if graphs is None:
            graphs = self.device.type == "cuda" and not (
                mesh is not None and mesh.staged)
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True captures CUDA graphs; it needs a "
                             f"CUDA device, got {self.device}")
        self.graphs = graphs
        self.compile_cache_dir = (enable_compile_cache(compile_cache)
                                  if compile_cache else None)
        self._compile_log = CompileLog(strict=strict_prewarm)
        if mesh is None:
            model = model.to(self.device)
        # under a mesh the model stays where the caller keeps it (the
        # host, for a model the card holds only sharded) until its shard
        # is cut and moved to this rank's device
        if compressed:
            # serve from the compressed pool: pack every SparseLinear offline
            # and flip the policy so skipped leaves keep masked semantics
            model = convert_to_compressed(model, cfg)
            cfg = cfg.replace(sparsity=dataclasses.replace(
                cfg.sparsity, mode="compressed"))
        self.mesh = mesh
        self.rules = None
        self.ring_traffic = None
        self.tp_collective = None
        if mesh is not None:
            self.rules = dict(SERVE_TP_RULES)
            # 'auto': compressed weights ride the sparse ring, so only
            # compressed bytes cross between ranks; dense ones have nothing
            # compressed to ship
            ring = compressed and tp_collective in ("auto", "ring")
            self.tp_collective = "ring" if ring else "gspmd"
            cfg = cfg.replace(sparsity=dataclasses.replace(
                cfg.sparsity, decode_ring=ring))
            self.ring_traffic = serve_ring_traffic_bytes(model, cfg,
                                                         mesh.size)
            # shard after conversion: the spec walk is structural, so it
            # sees the compressed leaves
            model = shard_model(model, mesh, self.rules, device=self.device)
        self.weight_stream = weight_stream_bytes(model, cfg)
        self.model = model
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv = kv
        self.attn = attn
        self.preempt_mode = preempt
        self.debug_invariants = debug_invariants
        self.scheduler = SlotScheduler(n_slots)
        self.pos = np.zeros(n_slots, np.int32)
        self.tok = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)
        self.results: Dict[int, RequestResult] = {}
        self.decode_steps = 0
        self.ticks = 0
        self.preemptions = 0
        self.prefill_calls = 0               # admissions that ran a prefill
        self.prefix_hits = 0                 # admissions served from the trie
        self.prefix_hit_tokens = 0           # prompt tokens skipped via hits
        self.swap_outs = 0
        self.swap_ins = 0
        self.index_evictions = 0
        self.rejected = 0
        self.prefill_lengths = set()
        self._slots: Dict[int, _SlotState] = {}
        self._suspended: Dict[int, _Suspended] = {}   # rid -> host state
        self._spec = spec
        self.spec_proposed = 0               # draft tokens offered to verify
        self.spec_accepted = 0               # draft tokens the target kept
        self.steps_saved = 0                 # target passes avoided
        self.draft_steps = 0                 # draft decode steps run
        self.index = PrefixIndex() if prefix_cache else None
        if kv == "paged":
            self.pool = BlockPool(cfg, n_slots, max_len, block_size,
                                  n_blocks, device=self.device, mesh=mesh,
                                  rules=self.rules)
            self.caches = self.pool.caches
            if spec is not None and self.pool.state:
                raise ValueError(
                    "spec= requires every cache leaf behind the block "
                    "table (slot-indexed state — SSM, conv tails, cross "
                    "K/V — cannot be rolled back by table rewind)")
            # max_len always rides in the bucket set so every admissible
            # prompt lands in a bucket
            self._prefill_buckets = tuple(sorted(set(
                prefill_buckets if prefill_buckets is not None
                else default_buckets(max_len)) | {max_len}))
        else:
            self.pool = None
            self.caches = init_local_caches(cfg, n_slots, max_len,
                                            self.device, mesh, self.rules)
            self._prefill_buckets = ()
        if spec is not None:
            # the draft is a view of the served model: shared embedding,
            # norms and router, re-ranked or strided linears
            self._draft, self._draft_cfg, self._cache_idx = make_draft(
                model, cfg, kind=spec.draft, stride=spec.stride)
            self.draft_stream = weight_stream_bytes(self._draft,
                                                    self._draft_cfg)
        self._make_entries()
        self._exec_shapes = None
        self._tick_wall: List[float] = []
        self.prewarm_seconds = 0.0
        if prewarm:
            self.prewarm()
        self.init_seconds = time.perf_counter() - t_init
        # anything captured from here on is a mid-serve compile — the
        # cold-start bill prewarm exists to remove (strict mode raises)
        self._compile_log.serving = True

    @staticmethod
    def _check_mesh(mesh, cfg, spec, device, graphs) -> None:
        """The refusals of ``mesh=``, before anything is built."""
        shape = getattr(mesh, "shape", {})
        if "model" not in shape:
            raise ValueError(f"serving mesh needs a 'model' axis, got "
                             f"{tuple(shape)} (see "
                             f"dist.api.make_serve_mesh)")
        if spec is not None:
            raise ValueError("spec= over a mesh is not supported yet (the "
                             "draft/verify entry points are untested under "
                             "tensor-parallel layouts)")
        if (cfg.family not in MESH_FAMILIES or cfg.local_global_period
                or cfg.input_mode != "tokens"):
            raise not_ported(f"mesh= for {cfg.name or cfg.family!r} (family "
                             f"{cfg.family!r})", "distribution")
        if torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device!r} but the mesh's rank runs on "
                             f"{mesh.device}")
        if graphs and mesh.staged:
            raise ValueError("graphs=True with the gloo backend on a card: "
                             "gloo's collectives stage through host memory, "
                             "which a CUDA graph cannot capture (serve eager, "
                             "or use NCCL)")

    # ------------------------------------------------------ entry points

    def _make_entries(self) -> None:
        """The engine's entry points, each a ``GraphEntry`` over one
        forward that ends in its greedy argmax.  All of them share one
        graph memory pool and one side stream, and capture the KV pools by
        address (the forwards update them in place)."""
        self.entries: Dict[str, GraphEntry] = {}
        self.graph_pool = self._stream = None
        if self.graphs:
            self.graph_pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        model, cfg, attn = self.model, self.cfg, self.attn
        caches = self.caches

        def entry(name, fn):
            if self.mesh is not None:
                fn = _in_mesh(fn, self.mesh, self.rules)
            self.entries[name] = GraphEntry(
                name, fn, device=self.device, graphs=self.graphs,
                log=self._compile_log, pool=self.graph_pool,
                stream=self._stream, fixed=lambda: leaves(caches),
                counters=None if self.mesh is None else self.mesh.stats)
            return self.entries[name]

        def decode(tok, pos, tbl=None):
            logits, _ = decode_step(model, cfg, caches, tok, pos, tbl,
                                    attn_impl=attn)
            return greedy_sample(logits)

        def prefill_one(batch, logit_pos):
            logits, pf = prefill(model, cfg, batch, logit_pos=logit_pos)
            return greedy_sample(logits), pf

        self._decode = entry("decode", decode)
        self._prefill = entry("prefill", prefill_one)
        if self._spec is None:
            return
        draft, dcfg, cache_idx = self._draft, self._draft_cfg, self._cache_idx
        k = self._spec.k

        def propose(tok, pos, tbl):
            drafts, _ = draft_propose_k(draft, dcfg, caches, tok, pos, tbl,
                                        k=k, attn_impl=attn,
                                        cache_idx=cache_idx)
            return drafts

        def verify(span, pos, tbl):
            logits, _ = verify_step(model, cfg, caches, span, pos, tbl,
                                    attn_impl=attn)
            return greedy_sample(logits)

        self._propose = entry("propose", propose)
        self._verify = entry("verify", verify)

    @property
    def prefill_buckets(self):
        return self.executable_shapes()["prefill_buckets"]

    def executable_shapes(self) -> Dict[str, object]:
        """The complete captured-shape universe of this engine config, the
        one source admission (``_plan`` buckets via ``prefill_buckets``),
        ``prewarm()`` and ``stats()`` (``executables_expected``) read.
        Paged: one pool-shaped graph each for decode (and propose / verify
        under ``spec=``), plus one prefill graph per bucket; the bucket set
        contains ``max_len``, so every admissible prompt lands in a bucket
        and the set is closed.  Slotted: the decode graph; prefill takes
        each prompt's own length, which no config bounds
        (``prewarm(prompt_lens=...)`` takes a trace's lengths)."""
        if self._exec_shapes is None:
            entries: Dict[str, int] = {"decode": 1}
            if self.pool is not None:
                entries["prefill"] = len(self._prefill_buckets)
            if self._spec is not None:
                entries["propose"] = 1
                entries["verify"] = 1
            self._exec_shapes = {
                "prefill_buckets": self._prefill_buckets,
                "entries": entries,
                "total": sum(entries.values()),
            }
        return self._exec_shapes

    def prewarm(self, prompt_lens: Sequence[int] = ()) -> None:
        """Capture the engine's complete graph set before any request is
        admitted (``GraphEntry.capture`` per shape, on abstract per-call
        arguments; without graphs, set up each shape's static buffers).
        Idempotent: shapes already built are skipped.  ``prompt_lens``
        adds explicit prefill lengths, as in the reference: the only way to
        prewarm slotted prefill, whose shape set is per-prompt."""
        t0 = time.perf_counter()
        shapes = self.executable_shapes()
        n = self.n_slots
        tok = abstract((n,), torch.long)
        pos = abstract((n,), torch.int32)
        tbl = (abstract((n, self.pool.table_width), torch.int32),
               ) if self.pool is not None else ()
        self._decode.capture(tok, pos, *tbl, label="decode")
        if self._spec is not None:
            k = self._spec.k
            self._propose.capture(tok, pos, *tbl, label=f"propose@k{k}")
            self._verify.capture(abstract((n, k + 1), torch.long), pos, *tbl,
                                 label=f"verify@k{k}")
        for b in sorted(set(shapes["prefill_buckets"]) | set(prompt_lens)):
            self._prefill.capture(abstract_batch(self.cfg, b),
                                  abstract((), torch.long),
                                  label=f"prefill@{b}")
        self.prewarm_seconds += time.perf_counter() - t0

    def compile_events(self) -> List[Dict[str, object]]:
        """Per-graph capture records (entry, label, phase, warm-up and total
        seconds), the observability feed for the CLI and chip_smoke."""
        return [dataclasses.asdict(e) for e in self._compile_log.events]

    # --------------------------------------------------------------- frontend

    def submit(self, req: Request) -> None:
        """Queue a request; one the pool can never serve is recorded as a
        rejected ``RequestResult`` instead of raising."""
        if req.prompt_len + req.max_new_tokens - 1 > self.max_len:
            self._reject(req, f"prompt {req.prompt_len} + gen "
                              f"{req.max_new_tokens} exceeds pool max_len "
                              f"{self.max_len}")
            return
        if self.pool is not None:
            need = self.pool.blocks_for(
                req.prompt_len + req.max_new_tokens - 1)
            if need > self.pool.usable_blocks:
                self._reject(req, f"needs {need} blocks, pool has "
                                  f"{self.pool.usable_blocks} usable")
                return
        self.scheduler.submit(req)

    def _reject(self, req: Request, reason: str) -> None:
        self.results[req.rid] = RequestResult(
            rid=req.rid, tokens=np.zeros(0, np.int32), admitted_at=-1,
            finished_at=-1, rejected=True, reason=reason)
        self.rejected += 1

    # ------------------------------------------------------------- admission

    def _plan(self, req: Request) -> "tuple[int, bool]":
        """Bucketed prefill plan ``(prefill_len, pad_up)``: the largest
        bucket <= prompt_len (the rest replays as forced decode), else the
        smallest bucket >= prompt_len with right padding.  Embeddings
        prompts (the vlm family) always pad up: they cannot replay through
        the token decode step.  Right padding is causal-safe for attention
        (and the audio family's encoder input is kept whole) but runs
        through a recurrence and changes its state, so the SSM and hybrid
        families plan no prefill for such a prompt (``(0, False)``): the
        slot starts from the zero state and the whole prompt replays as
        forced decode, exact and within the graph set.  (The reference
        pads up there and seeds the padded state.)"""
        plen = req.prompt_len
        if self.cfg.input_mode != "embeds":
            downs = [b for b in self.prefill_buckets if b <= plen]
            if downs:
                return max(downs), False
            if self.cfg.family in STATE_FAMILIES:
                return 0, False
        ups = [b for b in self.prefill_buckets if b >= plen]
        if ups:
            return min(ups), True
        return plen, False

    def _seed_positions(self, req: Request) -> int:
        pb, pad_up = self._plan(req)
        return req.prompt_len if pad_up else pb

    def _prefix_cacheable(self, req: Request) -> bool:
        """Prefix sharing is keyed on tokens and needs every cache leaf
        behind the block table (slot-indexed state: SSM state, conv tails,
        encoder cross K/V, is only regenerated by prefill)."""
        return (self.index is not None and not self.pool.state
                and set(req.inputs) == {"tokens"})

    def _match(self, req: Request, now: int
               ) -> "tuple[int, List[int], Optional[object]]":
        """Longest cached prefix of ``req``'s prompt: ``(m, blocks, node)``
        where ``blocks`` back positions [0, m) and ``node`` is the deepest
        trie node on the match path (for ``_reclaim``'s eviction pin).
        Capped at ``prompt_len - 1``: the last prompt token always feeds
        through decode to produce the first logits.

        The per-token pids collapse to one block per ``block_size`` span by
        taking the pid at each span's **last** matched position: a match
        that crosses a radix-node boundary mid-block sees the older
        branch's block and the later branch's copy-on-write block in that
        span, and only the latter holds the matched history
        (``serve/prefix.py``)."""
        if not self._prefix_cacheable(req):
            return 0, [], None
        toks = np.asarray(req.inputs["tokens"])[:req.prompt_len - 1]
        m, pids, node = self.index.match_path(toks, now)
        if m <= 0:
            return 0, [], None
        bs = self.pool.block_size
        return (m, [pids[min(i + bs - 1, m - 1)] for i in range(0, m, bs)],
                node)

    def _fits(self, req: Request, now: int) -> bool:
        """Block-aware admission gate.  A prefix hit needs one fresh block
        (the shared span is a table write; the first divergent write needs
        one block to copy or grow into) and **pins its match path** while
        reclaiming, so the eviction loop cannot drop the nodes that
        justified the one-block need.  A suspended request needs its
        swapped blocks back.  When the free heap is short, LRU-evict the
        prefix index before refusing."""
        if req.rid in self._suspended:
            return self._reclaim(
                max(self._suspended[req.rid].swap.n_blocks, 1))
        m, _, node = self._match(req, now)
        if m > 0 and self._reclaim(1, protect=(node,)):
            return True
        # no hit, or the match's own path pins the pool: fall back to the
        # full-prefill need with nothing protected (admission re-matches
        # and shares whatever smaller hit survives the eviction)
        return self._reclaim(self.pool.blocks_for(self._seed_positions(req)))

    def _reclaim(self, need: int, protect: Sequence = ()) -> bool:
        """Evict LRU prefix-index entries until ``need`` blocks are free (or
        nothing evictable is left); ``protect`` exempts the current
        admission's match path.  True when the allocation can proceed."""
        while not self.pool.can_alloc(need):
            if self.index is None or not self.index.evict_lru(
                    self.pool, protect=protect):
                return False
            self.index_evictions += 1
        return True

    def _admit(self, slot: int, req: Request, now: int) -> bool:
        """Install ``req`` into ``slot``.  False when the admission backed
        out (the blocks the fits-gate sized against are gone): the request
        is requeued at the queue front and the caller stops admitting this
        tick."""
        if self.pool is None:
            return self._admit_slotted(slot, req, now)
        if req.rid in self._suspended:
            return self._resume(slot, req)
        plen = req.prompt_len
        # prefix-cache hit: point the slot's table at the cached blocks and
        # replay only the divergent suffix through forced decode.  Matched
        # again here (not reused from _fits), so an eviction between the
        # two can never hand out a freed block.
        m, shared, _ = self._match(req, now)
        if m > 0:
            toks = np.asarray(req.inputs["tokens"])
            self.pool.share(slot, shared)
            self._slots[slot] = _SlotState(
                req=req, tokens=[], admitted_at=now,
                pending=[int(t) for t in toks[m + 1:plen]])
            self.pos[slot] = m
            self.tok[slot] = int(toks[m])
            self.active[slot] = True
            self.prefix_hits += 1
            self.prefix_hit_tokens += m
            return True
        pb, pad_up = self._plan(req)
        n_seed = plen if pad_up else pb
        if not self.pool.alloc(slot, self.pool.blocks_for(n_seed)):
            # the fits-gate sized this against a match that no longer
            # holds: requeue at the front, retry once blocks come back
            self.scheduler.preempt(slot)
            return False
        if pb:
            self.prefill_lengths.add(pb)
            self.prefill_calls += 1
            lp = torch.tensor((plen if pad_up else pb) - 1, dtype=torch.long)
            first, pf = self._prefill(
                batch_prompt(_bucketed(req.inputs, pb, pad_up)), lp)
            self.pool.seed(slot, pf, n_seed)
        else:                                # no prefill: from zero state
            self.pool.clear_state(slot)
        if n_seed >= plen:                   # prompt fully prefilled
            first = int(first[0])
            st = _SlotState(req=req, tokens=[first], admitted_at=now)
            self.pos[slot] = plen
            self.tok[slot] = first
        else:                                # catch up via forced decode
            toks = np.asarray(req.inputs["tokens"])
            st = _SlotState(req=req, tokens=[], admitted_at=now,
                            pending=[int(t) for t in toks[pb + 1:plen]])
            self.pos[slot] = pb
            self.tok[slot] = int(toks[pb])
        self._slots[slot] = st
        self.active[slot] = True
        if st.tokens and req.max_new_tokens <= 1:
            self._retire(slot, now)
        return True

    def _admit_slotted(self, slot: int, req: Request, now: int) -> bool:
        """Prefill ``req`` alone at its own length, seed a one-row decode
        cache from it and write that row into ``slot`` in place (the
        graphs hold the pool by address)."""
        plen = req.prompt_len
        self.prefill_lengths.add(plen)
        self.prefill_calls += 1
        first, pf = self._prefill(batch_prompt(req.inputs),
                                  torch.tensor(plen - 1, dtype=torch.long))
        single = init_local_caches(self.cfg, 1, self.max_len, self.device,
                                   self.mesh, self.rules)
        scatter_slot_(self.caches, seed_decode_caches(self.cfg, single, pf),
                      slot)
        first = int(first[0])
        self._slots[slot] = _SlotState(req=req, tokens=[first],
                                       admitted_at=now)
        self.pos[slot] = plen
        self.tok[slot] = first
        self.active[slot] = True
        if req.max_new_tokens <= 1:          # satisfied by prefill alone
            self._retire(slot, now)
        return True

    def _retire(self, slot: int, now: int) -> None:
        st = self._slots.pop(slot)
        self.results[st.req.rid] = RequestResult(
            rid=st.req.rid, tokens=np.asarray(st.tokens, np.int32),
            admitted_at=st.admitted_at, finished_at=now)
        self.scheduler.release(slot)
        self.active[slot] = False
        if self.pool is None:
            return                           # the row stays, stale, unread
        if self._prefix_cacheable(st.req):
            # register the prompt's (token -> block) mapping BEFORE the slot
            # drops its references: the index pins the blocks, so the
            # cached span never passes through the free heap
            toks = np.asarray(st.req.inputs["tokens"])[:st.req.prompt_len]
            bs = self.pool.block_size
            pids = [int(self.pool.table[slot, i // bs])
                    for i in range(len(toks))]
            self.index.insert(toks, pids, now, self.pool)
        self.pool.free(slot)
        self.pos[slot] = 0                   # idle rows write into trash:0
        self.tok[slot] = 0

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` back to the queue front.  ``preempt="replay"``
        drops the resident state (readmission replays from prefill);
        ``"suspend"`` swaps it to host (blocks, emitted tokens, prompt
        catch-up, position) and readmission restores it."""
        st = self._slots.pop(slot)
        if self.preempt_mode == "suspend":
            self._suspended[st.req.rid] = _Suspended(
                state=st, swap=self.pool.swap_out(slot),
                pos=int(self.pos[slot]), tok=int(self.tok[slot]))
            self.swap_outs += 1
            self.scheduler.suspend(slot)     # requeued at the FRONT, tagged
        else:
            self.pool.free(slot)
            self.scheduler.preempt(slot)     # requeued at the FRONT
        self.active[slot] = False
        self.pos[slot] = 0
        self.tok[slot] = 0
        self.preemptions += 1

    def _resume(self, slot: int, req: Request) -> bool:
        """Readmit a suspended request: swap its resident state back in and
        continue where it stopped (no prefill, no token replay).  Backs out
        (False: suspended again at the queue front) when the pool cannot
        back the swapped blocks despite the fits-gate."""
        sus = self._suspended.pop(req.rid)
        if not self.pool.swap_in(slot, sus.swap):
            self._suspended[req.rid] = sus
            self.scheduler.suspend(slot)
            return False
        self._slots[slot] = sus.state
        self.pos[slot] = sus.pos
        self.tok[slot] = sus.tok
        self.active[slot] = True
        self.swap_ins += 1
        return True

    def _prepare_slots(self, spec_set: Optional[set] = None) -> None:
        """Make every active slot writable for this tick, oldest admission
        first: back its write span (its next position, or the whole k+1
        span for a slot in ``spec_set``) and copy-on-write every shared
        block the span touches, so ``rollback`` only ever frees exclusive
        blocks.  When the pool runs dry, reclaim LRU prefix-index blocks,
        then demote the slot from speculation (a 1-wide span needs fewer
        blocks), then preempt the newest-admitted request (the oldest is
        never preempted, so progress is guaranteed)."""
        k = self._spec.k if self._spec is not None else 0
        bs = self.pool.block_size
        for slot in sorted(self._slots,
                           key=lambda s: (self._slots[s].admitted_at, s)):
            while slot in self._slots:       # not preempted by earlier victim
                pos = int(self.pos[slot])
                spec = spec_set is not None and slot in spec_set
                last = pos + (k if spec else 0)
                owned = self.pool._owned[slot]
                short = max(0, last // bs + 1 - len(owned))
                shared = [i for i in range(pos // bs,
                                           min(last // bs, len(owned) - 1) + 1)
                          if self.pool.ref[self.pool.table[slot, i]] > 1]
                ok = (self._reclaim(short + len(shared))
                      and self.pool.ensure(slot, last))
                for i in shared:
                    ok = ok and self.pool.cow(slot, i * bs)
                if ok:
                    break
                if spec:                     # cheapen before evicting anyone
                    spec_set.discard(slot)
                    continue
                victim = max(self._slots,
                             key=lambda s: (self._slots[s].admitted_at, s))
                self._preempt(victim)

    # ----------------------------------------------------------------- decode

    def step(self, now: int) -> None:
        """One batched decode tick over the pool (per-slot positions)."""
        if self._spec is not None:
            self._spec_step(now)
            return
        if self.pool is None:
            self.scheduler.record_occupancy()
            self._decode_tick(list(self._slots), (self.tok, self.pos), now)
            return
        self._prepare_slots()
        if not self._slots:
            return                           # everything was preempted
        self.scheduler.record_occupancy()
        if self.debug_invariants:
            self.check_invariants(
                active_pos={s: int(self.pos[s]) for s in self._slots})
        self._decode_tick(list(self._slots),
                          (self.tok, self.pos, self.pool.table), now)

    def _decode_tick(self, slots, arrays, now: int) -> None:
        """One decode forward over the host arrays (token ids, positions
        and, paged, the block table), then advance ``slots`` (in the order
        given) by the token it emitted or their next prompt token."""
        nxt = self._decode(*_host(*arrays)).cpu().numpy()
        self.decode_steps += 1
        for slot in slots:
            st = self._slots[slot]
            self.pos[slot] += 1
            if st.pending:                   # still consuming the prompt
                self.tok[slot] = st.pending.pop(0)
                continue
            st.tokens.append(int(nxt[slot]))
            self.tok[slot] = nxt[slot]
            if len(st.tokens) >= st.req.max_new_tokens:
                self._retire(slot, now)

    # -------------------------------------------------- speculative decoding

    def _masked(self, participants):
        """(tok, pos, table) host arrays with every non-participant row
        pointed at the trash block at position 0 — the disguise idle slots
        already wear — so a forward over them touches only the
        participants' blocks (the others' writes land in trash and their
        logits are never read)."""
        out = np.array([s not in participants for s in range(self.n_slots)])
        tbl = self.pool.table.copy()
        pos = self.pos.copy()
        tok = self.tok.copy()
        tbl[out] = TRASH_BLOCK
        pos[out] = 0
        tok[out] = 0
        return tok, pos, tbl

    def _spec_step(self, now: int) -> None:
        """One speculative tick: a plain decode forward for the slots that
        do not speculate, then one draft-propose + target-verify round for
        the others.

        A slot joins the verify span when its request opts in
        (``Request.spec`` over ``SpecConfig.default_on``), its k+1 span fits
        the table, and it is either replaying prompt tokens (``pending``:
        they ride the span as forced drafts, accepted by construction, up to
        k+1 positions per pass) or generating with at least 2 tokens of
        budget left.  A generating slot commits the longest draft prefix the
        target agrees with plus the target's token after it.  Either way
        the table then rolls back to the consumed position."""
        k = self._spec.k
        cap = self.pool.table_width * self.pool.block_size
        draft_set, forced_set = set(), set()
        for slot, st in self._slots.items():
            on = (st.req.spec if st.req.spec is not None
                  else self._spec.default_on)
            if not on or int(self.pos[slot]) + k >= cap:
                continue
            if st.pending:
                forced_set.add(slot)
            elif st.req.max_new_tokens - len(st.tokens) >= 2:
                draft_set.add(slot)
        spec_set = draft_set | forced_set
        self._prepare_slots(spec_set)
        if not self._slots:
            return                           # everything was preempted
        spec_set &= set(self._slots)
        draft_set &= spec_set
        forced_set &= spec_set
        plain = set(self._slots) - spec_set
        if self.debug_invariants:
            self.check_invariants(active_pos={
                s: (int(self.pos[s]), int(self.pos[s]) + k) if s in spec_set
                else int(self.pos[s]) for s in self._slots})
        if plain:
            self.scheduler.record_occupancy()
            self._decode_tick(sorted(plain), self._masked(plain), now)
        if not spec_set:
            return
        span = np.zeros((self.n_slots, k + 1), np.int32)
        span[:, 0] = self.tok
        if draft_set:
            drafts = self._propose(*_host(*self._masked(draft_set)))
            span[:, 1:] = drafts.cpu().numpy()
            self.draft_steps += k
        # forced rows: the next prompt tokens ride the span in place of
        # drafts; the oracle consumes them verbatim
        for slot in forced_set:
            pend = self._slots[slot].pending
            f = min(k, len(pend))
            span[slot, 1:] = 0
            span[slot, 1:1 + f] = pend[:f]
        _, pos, tbl = self._masked(spec_set)
        va = self._verify(*_host(span, pos, tbl)).cpu().numpy()  # [B, k+1]
        self.decode_steps += 1
        self.scheduler.record_occupancy()
        acc = accept_greedy(span[:, 1:], va)
        for slot in sorted(spec_set):
            st = self._slots[slot]
            if slot in forced_set:
                f = min(k, len(st.pending))
                del st.pending[:f]
                self.pos[slot] += f + 1
                if st.pending:               # prompt not done: no emission
                    self.tok[slot] = st.pending.pop(0)
                else:                        # first post-prompt emission
                    st.tokens.append(int(va[slot, f]))
                    self.tok[slot] = int(va[slot, f])
                self.steps_saved += f
            else:
                budget = st.req.max_new_tokens - len(st.tokens)
                n_commit = min(int(acc[slot]) + 1, budget)
                commit = [int(t) for t in va[slot, :n_commit]]
                st.tokens.extend(commit)
                self.pos[slot] += n_commit
                self.tok[slot] = commit[-1]
                self.spec_proposed += k
                self.spec_accepted += int(acc[slot])
                self.steps_saved += n_commit - 1
            # rewind: keep the blocks backing the consumed positions, free
            # the span tail (exclusive: _prepare_slots copied any shared
            # block of the span)
            self.pool.rollback(slot, int(self.pos[slot]))
            if st.tokens and len(st.tokens) >= st.req.max_new_tokens:
                self._retire(slot, now)

    # -------------------------------------------------------------- main loop

    def run(self, requests: Optional[List[Request]] = None
            ) -> Dict[int, RequestResult]:
        """Drive to completion: admit (one at a time, block-aware), then
        one decode tick, per scheduler tick."""
        for r in requests or ():
            self.submit(r)
        t = 0
        while self.scheduler.has_work():
            if self.pool is None:
                for slot, req in self.scheduler.admit(t):
                    self._admit(slot, req, t)
            else:
                # one at a time: each admission allocates blocks, and the
                # next fits-check must see the shrunken free list
                while True:
                    pairs = self.scheduler.admit(
                        t, fits=lambda r: self._fits(r, t), limit=1)
                    if not pairs or not self._admit(pairs[0][0], pairs[0][1],
                                                    t):
                        break
            if self.active.any():
                t0 = time.perf_counter()
                self.step(t)
                # step() reads its tokens back to the host, so this wall
                # time is synchronous: stats()["first_tick_s"] and
                # ["steady_tick_s"]
                self._tick_wall.append(time.perf_counter() - t0)
            t += 1
        self.ticks = t
        return self.results

    def check_invariants(self, active_pos: Optional[Dict[int, int]] = None
                         ) -> None:
        """Pool invariants with the engine's full reference picture: the
        prefix index's pins ride along as ``external_refs``, so the
        free-XOR-refcounted accounting closes."""
        self.pool.check_invariants(
            active_pos=active_pos,
            external_refs=self.index.block_refs() if self.index else None)

    def stats(self) -> Dict[str, float]:
        toks = sum(len(r.tokens) for r in self.results.values())
        ws = self.weight_stream
        log = self._compile_log
        out = {
            "tokens": float(toks),
            "decode_steps": float(self.decode_steps),
            "ticks": float(self.ticks),
            "occupancy": self.scheduler.occupancy(),
            # the capture bill per entry point: graphs actually captured
            # (prewarmed + lazy; without graphs, shape keys set up)
            "prefill_compiles": float(self._prefill.n_compiles),
            "decode_compiles": float(self._decode.n_compiles),
            "prewarmed_executables": float(log.prewarm_compiles),
            "mid_serve_compiles": float(log.mid_serve_compiles),
            "compile_seconds": float(log.compile_seconds),
            "prewarm_seconds": float(self.prewarm_seconds),
            "init_seconds": float(self.init_seconds),
            "warm_calls": float(sum(e.warm_calls
                                    for e in self.entries.values())),
            "executables_expected": float(
                self.executable_shapes()["total"]),
            "first_tick_s": float(self._tick_wall[0]
                                  if self._tick_wall else 0.0),
            "steady_tick_s": float(np.median(self._tick_wall[1:])
                                   if len(self._tick_wall) > 1 else 0.0),
            "prefill_calls": float(self.prefill_calls),
            "preemptions": float(self.preemptions),
            "rejected": float(self.rejected),
            # per-decode-step weight-stream traffic (every step re-reads
            # each linear once; see models.weight_stream_bytes)
            "weight_stream_bytes": float(ws["stream_bytes"]),
            "dense_weight_bytes": float(ws["dense_bytes"]),
            "weight_stream_ratio": float(ws["ratio"]),
            "tp": float(self.mesh.size if self.mesh is not None else 1),
        }
        if self.ring_traffic is not None:
            rt = self.ring_traffic
            # modeled per decode step (models.serve_ring_traffic_bytes):
            # what the ring ships compressed against the same ring shipping
            # dense weights; then what this rank's transport sent
            out.update({
                "ring_bytes_per_step": float(rt["ring_bytes"]),
                "ring_dense_bytes_per_step": float(rt["dense_ring_bytes"]),
                "ring_traffic_ratio": float(rt["ratio"]),
                "ring_linears": float(rt["ring_linears"]),
                "local_linears": float(rt["local_linears"]),
                "ring_sent_bytes": float(self.mesh.stats["ring_bytes"]),
                "gather_sent_bytes": float(self.mesh.stats["gather_bytes"]),
                "staged_bytes": float(self.mesh.stats["staged_bytes"]),
            })
        if self.pool is None:
            # the slotted layout preallocates every row: resident is its
            # capacity; leaves with a sequence axis are the KV stream, the
            # slot-indexed state (SSM state, conv tails) reports apart, as
            # the paged split does
            seq = _seq_leaves(self.cfg)
            nbytes = [_nbytes(t) for t in leaves(self.caches)]
            out["kv_bytes_resident"] = float(sum(
                n for n, s in zip(nbytes, seq) if s))
            out["kv_state_bytes"] = float(sum(
                n for n, s in zip(nbytes, seq) if not s))
            return out
        out.update({
            "kv_block_bytes": float(self.pool.bytes_per_block),
            "kv_bytes_peak": float(self.pool.peak_blocks
                                   * self.pool.bytes_per_block),
            "kv_bytes_capacity": float(self.pool.usable_blocks
                                       * self.pool.bytes_per_block),
            "kv_bytes_resident": float(self.pool.resident_bytes()),
            "kv_state_bytes": float(self.pool.state_bytes),
            "prefix_hits": float(self.prefix_hits),
            "prefix_hit_tokens": float(self.prefix_hit_tokens),
            "cow_copies": float(self.pool.cow_copies),
            "swap_outs": float(self.swap_outs),
            "swap_ins": float(self.swap_ins),
            "swap_bytes_resident": float(sum(
                s.swap.nbytes for s in self._suspended.values())),
            "index_evictions": float(self.index_evictions),
            "index_blocks": float(self.index.blocks if self.index else 0),
            "index_tokens": float(self.index.cached_tokens
                                  if self.index else 0),
        })
        if self._spec is not None:
            # acceptance = share of drafted tokens the target kept;
            # steps_saved = target passes the non-speculative engine would
            # have needed beyond those run
            out.update({
                "propose_compiles": float(self._propose.n_compiles),
                "verify_compiles": float(self._verify.n_compiles),
                "spec_proposed": float(self.spec_proposed),
                "spec_accepted": float(self.spec_accepted),
                "spec_acceptance": (self.spec_accepted
                                    / max(self.spec_proposed, 1)),
                "spec_steps_saved": float(self.steps_saved),
                "draft_steps": float(self.draft_steps),
                # per-draft-step weight-stream bytes of the draft view
                # (shared storage; the modeled read share, not extra bytes)
                "draft_stream_bytes": float(
                    self.draft_stream["stream_bytes"])})
        return out


def _bucketed(inputs: Dict[str, np.ndarray], pb: int, pad_up: bool
              ) -> Dict[str, np.ndarray]:
    """A prompt's arrays at its prefill bucket ``pb``: bucket-down cuts the
    token prompt (the rest replays through decode), pad-up right-pads the
    prompt (tokens or embeddings) on its sequence axis; the encoder's input
    is not positions and stays whole."""
    out = {}
    for name, a in inputs.items():
        a = np.asarray(a)
        if name == "tokens" and not pad_up:
            a = a[:pb]
        elif pad_up and name != "enc_embeds":
            a = np.pad(a, ((0, pb - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))
        out[name] = a
    return out


def _seq_leaves(cfg) -> List[bool]:
    """Per cache leaf (in ``leaves`` order): does it have a sequence axis,
    a shape that moves with ``max_len`` (probed on abstract caches)."""
    a = leaves(init_caches(cfg, 1, 1, device="meta"))
    b = leaves(init_caches(cfg, 1, 2, device="meta"))
    return [x.shape != y.shape for x, y in zip(a, b)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_mesh(fn, mesh, rules):
    """``fn`` run inside the mesh's ``axis_rules`` context."""
    def run(*args):
        with axis_rules(mesh, rules):
            return fn(*args)
    return run


def _host(*arrays: np.ndarray):
    """Host arrays as the CPU tensors an entry copies into its static
    buffers (token ids int64, positions and tables int32)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a, np.int64 if i == 0 else np.int32)) for i, a in enumerate(arrays))
