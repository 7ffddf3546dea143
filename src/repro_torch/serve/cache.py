"""Decode-cache seeding (counterpart of ``repro.serve.cache``).

``seed_decode_caches`` copies the per-layer caches emitted by ``prefill``
(length = prompt) into decode buffers of length ``max_len``.  Every leaf
length-clips to ``min(src, dst)`` keeping the *last* positions, so a prompt
longer than the buffer degrades to a truncated context instead of a shape
error.  The function is pure: it returns new tensors and leaves ``caches``
untouched, so a zero template can be re-seeded for every request.  The
dense and MoE families are ported (the MoE prefill returns its dense and
MoE stacks apart, and they are concatenated along the layer axis here); the
slotted ``scatter_slot`` comes with the slotted layout.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _seed_leaf(dst: torch.Tensor, src: torch.Tensor,
               src_len: Optional[int]) -> torch.Tensor:
    """Copy of ``dst`` ([stack, batch, seq, ...]) whose first
    min(src, dst) positions hold ``src``'s last ones; ``src_len`` first
    clips the source to its first src_len positions (bucketed prefill:
    the tail is padding and never lands in a decode cache)."""
    if src_len is not None:
        src = src[:, :, :src_len]
    ln = min(src.shape[2], dst.shape[2])
    out = dst.clone()
    out[:, :, :ln] = src[:, :, src.shape[2] - ln:].to(dst.dtype)
    return out


def seed_decode_caches(cfg, caches: Dict[str, torch.Tensor],
                       pf: Dict[str, torch.Tensor],
                       src_len: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """Prefill caches ``pf`` -> decode buffers shaped like ``caches``
    (from ``init_caches``); returns a new dict."""
    if cfg.family == "moe":
        parts = ([pf["dense"]] if cfg.first_dense_layers else []) + [pf["moe"]]
        pf = {f: torch.cat([part[f] for part in parts]) for f in parts[0]}
    elif cfg.family != "dense":
        raise NotImplementedError(f"cache seeding for family {cfg.family!r} "
                                  f"comes with that family's port")
    return {f: _seed_leaf(caches[f], pf[f], src_len) for f in caches}
