"""Request abstraction for the serving subsystem (a copy of
``repro.serve.request``: pure Python, no framework).

A Request carries one *unbatched* prompt in whatever modality the model
family consumes (``tokens`` [S], ``embeds`` [S, d] for embedding-input
models, plus ``enc_embeds`` [Se, d] for enc-dec audio models), a generation
budget, and an arrival tick.  Time is measured in scheduler ticks — one tick
per batched decode step — so traces are deterministic and replayable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request.

    inputs: unbatched prompt arrays (no leading batch axis).
    max_new_tokens: total tokens to emit, *including* the first token that
        falls out of prefill (matching the fixed-batch oracle, which emits
        argmax(prefill logits) followed by max_new_tokens - 1 decode steps).
    arrival: scheduler tick at which the request becomes admissible.
    spec: per-request speculative-decoding override when the engine runs
        with ``spec=SpecConfig(...)`` — True forces drafting for this
        request, False opts out (throughput traffic that prefers batched
        target steps), None defers to ``SpecConfig.default_on``.
    """

    rid: int
    inputs: Dict[str, np.ndarray]
    max_new_tokens: int
    arrival: int = 0
    spec: Optional[bool] = None

    @property
    def prompt_len(self) -> int:
        if "tokens" in self.inputs:
            return int(self.inputs["tokens"].shape[0])
        return int(self.inputs["embeds"].shape[0])


@dataclasses.dataclass
class RequestResult:
    """Completed request: emitted tokens plus admission/finish ticks.

    ``rejected=True`` marks a request the engine refused at submit time
    (oversize for the pool): ``tokens`` is empty, ``reason`` says why, and
    the ticks are -1.  Recording a rejection instead of raising keeps one
    bad request from killing every other in-flight request in the trace."""

    rid: int
    tokens: np.ndarray           # int32 [max_new_tokens]
    admitted_at: int = 0
    finished_at: int = 0
    rejected: bool = False
    reason: str = ""


def synthetic_request(cfg, rng: np.random.Generator, rid: int,
                      prompt_len: int, max_new_tokens: int,
                      arrival: int = 0) -> Request:
    """Family-shaped random prompt (mirrors the launch.serve input builder)."""
    inputs: Dict[str, np.ndarray] = {}
    if cfg.input_mode == "embeds":
        inputs["embeds"] = rng.standard_normal(
            (prompt_len, cfg.d_model)).astype(np.float32)
    else:
        inputs["tokens"] = rng.integers(
            0, cfg.vocab, (prompt_len,)).astype(np.int32)
    if cfg.family == "audio":
        inputs["enc_embeds"] = rng.standard_normal(
            (cfg.enc_seq, cfg.d_model)).astype(np.float32)
        inputs.setdefault("tokens", rng.integers(
            0, cfg.vocab, (prompt_len,)).astype(np.int32))
    return Request(rid=rid, inputs=inputs, max_new_tokens=max_new_tokens,
                   arrival=arrival)


def synthetic_trace(cfg, n_requests: int, prompt_len: int,
                    gen_lens: Sequence[int], seed: int = 0,
                    arrival_every: int = 0) -> List[Request]:
    """A mixed-length trace: equal prompt lengths (so the fixed-batch oracle
    can prefill jointly), generation budgets cycling through ``gen_lens``,
    and optional staggered arrivals (request i arrives at i * arrival_every).
    """
    rng = np.random.default_rng(seed)
    return [synthetic_request(cfg, rng, rid=i, prompt_len=prompt_len,
                              max_new_tokens=gen_lens[i % len(gen_lens)],
                              arrival=i * arrival_every)
            for i in range(n_requests)]


def shared_prefix_trace(cfg, n_requests: int, prefix_len: int,
                        suffix_len: int, gen_lens: Sequence[int],
                        seed: int = 0, arrival_every: int = 0,
                        n_prefixes: int = 1) -> List[Request]:
    """The million-user-shaped trace: every request's token prompt is a
    shared ``prefix_len``-token system prompt (one of ``n_prefixes``
    variants, round-robin) followed by a per-request random
    ``suffix_len``-token suffix.  Token-input families only — prefix
    caching is keyed on tokens (the audio family's requests also carry
    encoder frames, which this trace has none of: the reference builds
    them without and its prefill fails; here it raises up front)."""
    if cfg.input_mode != "tokens" or cfg.family == "audio":
        raise ValueError("shared_prefix_trace needs a token-input family "
                         f"(cfg.input_mode={cfg.input_mode!r}, family "
                         f"{cfg.family!r})")
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, cfg.vocab, (prefix_len,)).astype(np.int32)
                for _ in range(n_prefixes)]
    reqs = []
    for i in range(n_requests):
        suffix = rng.integers(0, cfg.vocab, (suffix_len,)).astype(np.int32)
        toks = np.concatenate([prefixes[i % n_prefixes], suffix])
        reqs.append(Request(rid=i, inputs={"tokens": toks},
                            max_new_tokens=gen_lens[i % len(gen_lens)],
                            arrival=i * arrival_every))
    return reqs
