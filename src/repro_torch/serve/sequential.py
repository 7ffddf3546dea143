"""Fixed-batch (sequential) serving loop, the oracle (counterpart of
``repro.serve.sequential``).

Prefill one batch jointly, then greedy-decode every row in lockstep at one
scalar position until the batch's *longest* budget is met; each request's
output is trimmed to its own budget.  Requests that finish early burn
their row, which is the inefficiency the continuous engine removes, and
why this loop is kept as the token-equality oracle and the throughput
baseline.

The caches are the slotted layout (``init_caches``: one row per request),
written in place.  On the card each forward runs as a CUDA graph
(``serve.prewarm.GraphEntry``), as the engine's do, so the two compare
graphed against graphed: one prefill graph per batch shape, and one decode
graph per (batch size, max_len) holding that size's caches by address.
The decode position is an argument, a 0-d int32 tensor copied into the
graph's static input before every replay; a Python int would be baked into
the capture and every replay would write the first position.
``graphs=False`` runs every forward eagerly; the CPU always does.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import decode_step, init_caches, prefill
from repro_torch.models.common import greedy_sample
from repro_torch.serve.cache import leaves, seed_decode_caches
from repro_torch.serve.prewarm import (CompileLog, GraphEntry, abstract,
                                       batch_inputs)
from repro_torch.serve.request import Request, RequestResult


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FixedBatch:
    """The fixed-batch loop's device state, kept from batch to batch: the
    prefill entry, and per (batch size, max_len) the slotted caches and
    the decode entry that captures them.  ``device`` defaults to ``cuda``
    and raises when no card is present; ``graphs`` (default: on for a CUDA
    device) captures the forwards as CUDA graphs."""

    def __init__(self, model, cfg, device="cuda",
                 graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        self.graphs = self.device.type == "cuda" if graphs is None else graphs
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True captures CUDA graphs; it needs a "
                             f"CUDA device, got {self.device}")
        self.model = model.to(self.device)
        self.cfg = cfg
        self.log = CompileLog()
        self._pool = self._stream = None
        if self.graphs:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

        def prefill_fn(batch):
            logits, pf = prefill(self.model, cfg, batch)
            return greedy_sample(logits), pf
        self._prefill = self._entry("prefill", prefill_fn)
        self._decoders: Dict[Tuple[int, int], GraphEntry] = {}
        self.caches: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}

    def _entry(self, name, fn, fixed=list) -> GraphEntry:
        return GraphEntry(name, fn, device=self.device, graphs=self.graphs,
                          log=self.log, pool=self._pool, stream=self._stream,
                          fixed=fixed)

    def _decoder(self, batch: int, max_len: int) -> GraphEntry:
        key = (batch, max_len)
        if key not in self._decoders:
            caches = init_caches(self.cfg, batch, max_len, device=self.device)
            self.caches[key] = caches
            model, cfg = self.model, self.cfg

            def decode(tok, pos):
                logits, _ = decode_step(model, cfg, caches, tok.long(), pos)
                return greedy_sample(logits)
            entry = self._entry("decode", decode,
                                fixed=lambda: leaves(caches))
            # captured before any batch is seeded: the warm-up writes
            # token 0 at position 0 of every row
            entry.capture(abstract((batch,), torch.int32),
                          abstract((), torch.int32),
                          label=f"decode@{batch}x{max_len}")
            self._decoders[key] = entry
        return self._decoders[key]

    @property
    def n_graphs(self) -> int:
        """Shapes built so far (graphs captured, on the card)."""
        return len(self.log.events)

    def run(self, requests: List[Request], max_len: Optional[int] = None
            ) -> Tuple[Dict[int, RequestResult], Dict[str, float]]:
        """Decode one fixed batch jointly -> (results by rid, stats).

        All prompts must share one length (joint prefill is rectangular).
        The batch runs ``max(max_new_tokens) - 1`` decode steps."""
        plens = {r.prompt_len for r in requests}
        if len(plens) != 1:
            raise ValueError(f"fixed batch needs equal prompt lengths: "
                             f"{sorted(plens)}")
        prompt_len = plens.pop()
        gen = max(r.max_new_tokens for r in requests)
        max_len = max_len or prompt_len + gen
        batch = batch_inputs([r.inputs for r in requests])
        decode = self._decoder(len(requests), max_len)
        caches = self.caches[len(requests), max_len]

        _sync(self.device)
        t0 = time.perf_counter()
        first, pf = self._prefill(batch)
        # seed in place: the decode graph holds these tensors by address
        for leaf in leaves(caches):
            leaf.zero_()
        for leaf, seeded in zip(leaves(caches), leaves(
                seed_decode_caches(self.cfg, caches, pf))):
            leaf.copy_(seeded)
        tok = first.clone()
        _sync(self.device)
        t_prefill = time.perf_counter() - t0

        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            # entry outputs are the graph's static tensors: keep a copy
            tok = decode(tok, torch.tensor(prompt_len + i,
                                           dtype=torch.int32)).clone()
            out.append(tok)
        tokens = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        t_decode = (time.perf_counter() - t0) / max(gen - 1, 1)

        results = {r.rid: RequestResult(rid=r.rid,
                                        tokens=tokens[i, :r.max_new_tokens],
                                        finished_at=gen - 1)
                   for i, r in enumerate(requests)}
        stats = {"decode_steps": float(gen - 1), "t_prefill": t_prefill,
                 "t_per_decode": t_decode}
        return results, stats


    def serve_sequential(self, requests: List[Request], n_slots: int,
                         max_len: Optional[int] = None
                         ) -> Tuple[Dict[int, RequestResult],
                                    Dict[str, float]]:
        """FCFS fixed batches of ``n_slots``: each batch runs to its
        slowest member before the next batch starts (no slot refill).
        Stats: ``decode_steps``, ``t_prefill`` and ``graphs`` (shapes built
        so far: a second call on this state captures nothing new)."""
        order = sorted(requests, key=lambda r: (r.arrival, r.rid))
        results: Dict[int, RequestResult] = {}
        steps = t_prefill = 0.0
        for i in range(0, len(order), n_slots):
            res, stats = self.run(order[i:i + n_slots], max_len=max_len)
            results.update(res)
            steps += stats["decode_steps"]
            t_prefill += stats["t_prefill"]
        return results, {"decode_steps": steps, "t_prefill": t_prefill,
                         "graphs": float(self.n_graphs)}


def serve_fixed_batch(model, cfg, requests: List[Request],
                      max_len: Optional[int] = None, device="cuda",
                      graphs: Optional[bool] = None
                      ) -> Tuple[Dict[int, RequestResult], Dict[str, float]]:
    """Decode one fixed batch jointly; returns (results by rid, stats)
    (``FixedBatch.run`` on a fresh state)."""
    return FixedBatch(model, cfg, device, graphs).run(requests, max_len)


def serve_sequential(model, cfg, requests: List[Request], n_slots: int,
                     max_len: Optional[int] = None, device="cuda",
                     graphs: Optional[bool] = None
                     ) -> Tuple[Dict[int, RequestResult], Dict[str, float]]:
    """``FixedBatch.serve_sequential`` on a fresh state.  A caller serving
    several traces keeps one ``FixedBatch`` instead, so its graphs are
    captured once."""
    return FixedBatch(model, cfg, device, graphs).serve_sequential(
        requests, n_slots, max_len)
