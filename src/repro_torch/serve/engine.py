"""Continuous-batching serve engine over the paged KV pool (counterpart of
``repro.serve.engine``).

The engine owns a ``BlockPool`` and a per-slot position vector and
interleaves two operations:

* **prefill-on-admission** — when the scheduler places a queued request in
  a free slot (and the pool has blocks for it), the engine prefills that
  request alone (batch 1) at a bucketed length and writes the caches into
  the slot's blocks (``BlockPool.seed``).  Token prompts bucket DOWN and
  feed the remaining prompt tokens through the batched decode step as
  *forced* tokens (exact: decode recomputes the K/V the full prefill would
  have written); a prompt shorter than the smallest bucket buckets UP with
  right padding and reads its logits at ``prompt_len - 1``.
* **batched decode** — one ``decode_step`` per tick over every slot with
  the per-slot position vector; decode reads K/V through the block table
  (``attn="fused"``: the ``paged_gqa_decode`` / ``paged_mla_decode`` kernel
  walks it in-kernel; ``"gather"``: the oracle read).  The dense (GQA) and
  MoE (MLA) families are served; in the MoE family idle rows and prompt
  padding are tokens like any other and compete for expert capacity, as in
  the reference.  Idle rows carry position 0, token 0 and
  an all-trash table row, so they write the trash block and their logits
  are never read.

Blocks are appended lazily (one every ``block_size`` ticks per slot); when
the pool runs dry the newest-admitted request is preempted back to the
queue front and later replays from prefill (greedy decode makes the replay
deterministic).

Not ported yet (the constructor raises ``NotImplementedError``): the
slotted layout, prefix caching, suspend-to-host preemption, speculative
decoding, tensor-parallel meshes and executable prewarming.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import (convert_to_compressed, decode_step, prefill,
                                weight_stream_bytes)
from repro_torch.serve.paged import BlockPool, default_buckets
from repro_torch.serve.request import Request, RequestResult
from repro_torch.serve.scheduler import SlotScheduler


@dataclasses.dataclass
class _SlotState:
    req: Request
    tokens: List[int]
    admitted_at: int
    # prompt tokens not yet fed (bucketed-down prefill catch-up); while
    # non-empty the slot is still consuming its prompt and emits nothing
    pending: List[int] = dataclasses.field(default_factory=list)


def not_ported(feature: str, slice_: str) -> NotImplementedError:
    """The error for a reference feature a later slice of the port brings."""
    return NotImplementedError(f"{feature} is not ported yet; it comes with "
                               f"the {slice_} slice of the port")


class ServeEngine:
    """Continuous-batching greedy-decode engine on one device.

    ``compressed=True`` converts the model to the compressed N:M serving
    format at init (``models.convert_to_compressed``) and serves from it.
    ``block_size`` / ``n_blocks`` / ``prefill_buckets`` configure the paged
    pool; ``attn`` picks the paged read ('fused' kernel or 'gather'
    oracle); ``debug_invariants=True`` cross-checks the block tables before
    every decode tick.  ``device`` defaults to ``cuda`` and raises when no
    card is present."""

    def __init__(self, model, cfg, n_slots: int, max_len: int,
                 compressed: bool = False, kv: str = "paged",
                 block_size: int = 4, n_blocks: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 attn: str = "gather", prefix_cache: bool = False,
                 preempt: str = "replay", debug_invariants: bool = False,
                 mesh=None, spec=None, prewarm: bool = False,
                 device="cuda"):
        if kv == "slotted":
            raise not_ported("kv='slotted'", "slotted-cache/sequential-oracle")
        if kv != "paged":
            raise ValueError(f"kv must be 'paged', got {kv!r}")
        if attn not in ("gather", "fused"):
            raise ValueError(f"attn must be 'gather' or 'fused', got {attn!r}")
        if preempt == "suspend":
            raise not_ported("preempt='suspend'", "serve-features")
        if preempt != "replay":
            raise ValueError(f"preempt must be 'replay', got {preempt!r}")
        if prefix_cache:
            raise not_ported("prefix_cache=True", "serve-features")
        if spec is not None:
            raise not_ported("spec= (speculative decoding)", "serve-features")
        if mesh is not None:
            raise not_ported("mesh= (tensor-parallel serving)", "distribution")
        if prewarm:
            raise not_ported("prewarm=True", "cold-start")
        self.device = resolve_device(device)
        model = model.to(self.device)
        if compressed:
            # serve from the compressed pool: pack every SparseLinear offline
            # and flip the policy so skipped leaves keep masked semantics
            model = convert_to_compressed(model, cfg)
            cfg = cfg.replace(sparsity=dataclasses.replace(
                cfg.sparsity, mode="compressed"))
        self.weight_stream = weight_stream_bytes(model, cfg)
        self.model = model
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.attn = attn
        self.debug_invariants = debug_invariants
        self.scheduler = SlotScheduler(n_slots)
        self.pos = np.zeros(n_slots, np.int32)
        self.tok = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)
        self.results: Dict[int, RequestResult] = {}
        self.decode_steps = 0
        self.ticks = 0
        self.preemptions = 0
        self.prefill_calls = 0
        self.rejected = 0
        self.prefill_lengths = set()
        self._slots: Dict[int, _SlotState] = {}
        self.pool = BlockPool(cfg, n_slots, max_len, block_size, n_blocks,
                              device=self.device)
        # max_len always rides in the bucket set so every admissible prompt
        # lands in a bucket
        self.prefill_buckets = tuple(sorted(set(
            prefill_buckets if prefill_buckets is not None
            else default_buckets(max_len)) | {max_len}))

    # --------------------------------------------------------------- frontend

    def submit(self, req: Request) -> None:
        """Queue a request; one the pool can never serve is recorded as a
        rejected ``RequestResult`` instead of raising."""
        if set(req.inputs) != {"tokens"}:
            raise not_ported("non-token request inputs", "other-families")
        if req.prompt_len + req.max_new_tokens - 1 > self.max_len:
            self._reject(req, f"prompt {req.prompt_len} + gen "
                              f"{req.max_new_tokens} exceeds pool max_len "
                              f"{self.max_len}")
            return
        need = self.pool.blocks_for(req.prompt_len + req.max_new_tokens - 1)
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
        smallest bucket >= prompt_len with right padding."""
        plen = req.prompt_len
        downs = [b for b in self.prefill_buckets if b <= plen]
        if downs:
            return max(downs), False
        ups = [b for b in self.prefill_buckets if b >= plen]
        if ups:
            return min(ups), True
        return plen, False

    def _seed_positions(self, req: Request) -> int:
        pb, pad_up = self._plan(req)
        return req.prompt_len if pad_up else pb

    def _fits(self, req: Request) -> bool:
        return self.pool.can_alloc(
            self.pool.blocks_for(self._seed_positions(req)))

    def _admit(self, slot: int, req: Request, now: int) -> bool:
        plen = req.prompt_len
        pb, pad_up = self._plan(req)
        n_seed = plen if pad_up else pb
        if not self.pool.alloc(slot, self.pool.blocks_for(n_seed)):
            self.scheduler.preempt(slot)     # back out: retry next tick
            return False
        toks = np.asarray(req.inputs["tokens"])
        prompt = toks[:pb] if not pad_up else np.pad(toks, (0, pb - plen))
        batch = {"tokens": torch.tensor(prompt[None], dtype=torch.long,
                                        device=self.device)}
        self.prefill_lengths.add(pb)
        self.prefill_calls += 1
        logits, pf = prefill(self.model, self.cfg, batch,
                             logit_pos=(plen if pad_up else pb) - 1)
        self.pool.seed(slot, pf, n_seed)
        if n_seed >= plen:                   # prompt fully prefilled
            first = int(logits[0].argmax())
            st = _SlotState(req=req, tokens=[first], admitted_at=now)
            self.pos[slot] = plen
            self.tok[slot] = first
        else:                                # catch up via forced decode
            st = _SlotState(req=req, tokens=[], admitted_at=now,
                            pending=[int(t) for t in toks[pb + 1:plen]])
            self.pos[slot] = pb
            self.tok[slot] = int(toks[pb])
        self._slots[slot] = st
        self.active[slot] = True
        if st.tokens and req.max_new_tokens <= 1:
            self._retire(slot, now)
        return True

    def _retire(self, slot: int, now: int) -> None:
        st = self._slots.pop(slot)
        self.results[st.req.rid] = RequestResult(
            rid=st.req.rid, tokens=np.asarray(st.tokens, np.int32),
            admitted_at=st.admitted_at, finished_at=now)
        self.scheduler.release(slot)
        self.active[slot] = False
        self.pool.free(slot)
        self.pos[slot] = 0                   # idle rows write into trash:0
        self.tok[slot] = 0

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` back to the queue front; readmission replays it
        from prefill."""
        self._slots.pop(slot)
        self.pool.free(slot)
        self.scheduler.preempt(slot)
        self.active[slot] = False
        self.pos[slot] = 0
        self.tok[slot] = 0
        self.preemptions += 1

    def _prepare_slots(self) -> None:
        """Back every active slot's next write position, oldest admission
        first; when the pool runs dry, preempt the newest-admitted request
        (the oldest is never preempted, so progress is guaranteed)."""
        for slot in sorted(self._slots,
                           key=lambda s: (self._slots[s].admitted_at, s)):
            while slot in self._slots:
                if self.pool.ensure(slot, int(self.pos[slot])):
                    break
                victim = max(self._slots,
                             key=lambda s: (self._slots[s].admitted_at, s))
                self._preempt(victim)

    # ----------------------------------------------------------------- decode

    def step(self, now: int) -> None:
        """One batched decode tick over the pool (per-slot positions)."""
        self._prepare_slots()
        if not self._slots:
            return                           # everything was preempted
        self.scheduler.record_occupancy()
        if self.debug_invariants:
            self.pool.check_invariants(
                active_pos={s: int(self.pos[s]) for s in self._slots})
        dev = self.device
        logits, self.pool.caches = decode_step(
            self.model, self.cfg, self.pool.caches,
            torch.tensor(self.tok, dtype=torch.long, device=dev),
            torch.tensor(self.pos, device=dev), self.pool.device_table(),
            attn_impl=self.attn)
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()
        self.decode_steps += 1
        for slot in list(self._slots):
            st = self._slots[slot]
            self.pos[slot] += 1
            if st.pending:                   # still consuming the prompt
                self.tok[slot] = st.pending.pop(0)
                continue
            st.tokens.append(int(nxt[slot]))
            self.tok[slot] = nxt[slot]
            if len(st.tokens) >= st.req.max_new_tokens:
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
            while True:
                pairs = self.scheduler.admit(t, fits=self._fits, limit=1)
                if not pairs or not self._admit(pairs[0][0], pairs[0][1], t):
                    break
            if self.active.any():
                self.step(t)
            t += 1
        self.ticks = t
        return self.results

    def check_invariants(self, active_pos: Optional[Dict[int, int]] = None
                         ) -> None:
        self.pool.check_invariants(active_pos=active_pos)

    def stats(self) -> Dict[str, float]:
        toks = sum(len(r.tokens) for r in self.results.values())
        ws = self.weight_stream
        return {
            "tokens": float(toks),
            "decode_steps": float(self.decode_steps),
            "ticks": float(self.ticks),
            "occupancy": self.scheduler.occupancy(),
            "prefill_calls": float(self.prefill_calls),
            "preemptions": float(self.preemptions),
            "rejected": float(self.rejected),
            # per-decode-step weight-stream traffic (every step re-reads
            # each linear once; see models.weight_stream_bytes)
            "weight_stream_bytes": float(ws["stream_bytes"]),
            "dense_weight_bytes": float(ws["dense_bytes"]),
            "weight_stream_ratio": float(ws["ratio"]),
            "kv_block_bytes": float(self.pool.bytes_per_block),
            "kv_bytes_peak": float(self.pool.peak_blocks
                                   * self.pool.bytes_per_block),
            "kv_bytes_capacity": float(self.pool.usable_blocks
                                       * self.pool.bytes_per_block),
        }
