"""Self-speculative decoding on the sparsity ladder (counterpart of
``repro.serve.speculative``).

The draft is a cheaper *view* of the served model (``models.make_draft``):
its compressed n:m linears re-ranked to 1:m (``"rerank"``), or every
``stride``-th block (``"skip"``).  ``draft_propose_k`` runs it k times
through the one-token decode path, writing its K/V into the target's own
paged pool (every draft write is overwritten by the verify pass, so no
second cache exists).  The target then scores the k+1-token span in one
``models.verify_step`` and ``accept_greedy`` keeps the longest draft prefix
that matches the target's argmax, plus the target's own token after it:
every committed token is the target's greedy choice given the committed
prefix, so the emitted stream is the non-speculative engine's.  Rejected
span positions roll back at the table level (``BlockPool.rollback``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import decode_step

DRAFT_KINDS = ("rerank", "skip")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding policy for ``ServeEngine(spec=...)``.

    k — draft tokens proposed per verify (the verify span is k + 1 wide).
    draft — 'rerank' (1:m re-rank of the compressed model; the engine must
        serve compressed) or 'skip' (stride-``stride`` skip-layer stack).
    stride — layer stride of the 'skip' draft.
    default_on — whether slots draft unless their request says otherwise
        (``Request.spec`` overrides it per request)."""

    k: int = 3
    draft: str = "rerank"
    stride: int = 2
    default_on: bool = True

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"need k >= 1, got {self.k}")
        if self.draft not in DRAFT_KINDS:
            raise ValueError(f"draft must be one of {DRAFT_KINDS}, "
                             f"got {self.draft!r}")
        if self.stride < 2:
            raise ValueError(f"need stride >= 2, got {self.stride}")


def draft_propose_k(draft, draft_cfg, caches: Dict[str, torch.Tensor],
                    tok: torch.Tensor, pos: torch.Tensor,
                    block_table: torch.Tensor, *, k: int, attn_impl: str,
                    cache_idx: Optional[np.ndarray] = None):
    """Propose k greedy draft tokens per row -> (drafts [B, k], caches).

    k one-token ``decode_step`` calls through the draft at positions ``pos
    .. pos + k - 1``, writing the draft's K/V into the target's pools in
    place (rows the engine masked to the trash table write only the trash
    block).  With a skip draft, ``cache_idx`` maps draft layer j to target
    pool layer ``cache_idx[j]``; the skipped layers' pools are untouched."""
    toks = []
    t = tok
    for i in range(k):
        logits, caches = decode_step(draft, draft_cfg, caches, t, pos + i,
                                     block_table, attn_impl=attn_impl,
                                     layers=cache_idx)
        t = logits.argmax(-1).to(tok.dtype)
        toks.append(t)
    return torch.stack(toks, dim=1), caches


def accept_greedy(drafts: np.ndarray, verify_argmax: np.ndarray) -> np.ndarray:
    """Accepted-draft count per row under greedy acceptance: drafts [B, k],
    verify_argmax [B, k+1] (the target's argmax at every span offset) ->
    int [B] in [0, k], the length of the longest prefix where the draft
    matched the target.  The engine commits ``verify_argmax[:, :a + 1]``."""
    k = drafts.shape[1]
    match = np.cumprod(drafts == verify_argmax[:, :k], axis=1)
    return match.sum(axis=1).astype(np.int64)
