"""Decode-cache seeding (counterpart of ``repro.serve.cache``).

``seed_decode_caches`` copies the per-layer caches emitted by ``prefill``
(length = prompt) into decode buffers of length ``max_len``.  Every leaf
length-clips to ``min(src, dst)`` keeping the *last* positions, so a prompt
longer than the buffer degrades to a truncated context instead of a shape
error.  A kept position ``p`` lands at index ``p mod L`` of a length-L
buffer: the ring layout the slotted read assumes (``_ring_valid``: slot j
holds position ``pos - ((pos - j) mod L)``), and the plain one while the
prompt fits.  The reference copies the last L positions to indices
0..L-1 instead, which breaks a windowed (gemma2 local) ring when the
prompt is longer than the window and not a multiple of it; the port
differs there on purpose.  The function is pure: it returns new tensors
and leaves ``caches`` untouched, so a zero template can be re-seeded for
every request.  The dense and MoE families are ported (the MoE prefill
returns its dense and MoE stacks apart, and they are concatenated along
the layer axis here; gemma2's flat prefill stack is cut into its local
and global layers when the caches keep them apart), and so are the SSM
family, whose state is position-free and is copied as prefill left it
(a copy: decode writes the state in place, and must not write the
prefill's), and the hybrid, whose "groups" / "tail" state is copied so
and whose "attn" caches are seeded as any other KV leaf.  The vlm family
seeds as the dense one; the audio family seeds its "self" K/V as any KV
leaf and copies the prefill's cross K/V whole (the encoder's length is
not a position).

``scatter_slot`` writes a batch-1 cache tree into batch index ``slot`` of
an n-slot pool tree (the slotted engine's admission).  The slot axis is
found structurally, per leaf: the one axis where the pool's shape differs
from the single request's.  ``scatter_slot`` is pure, as the reference's;
``scatter_slot_`` writes the pool in place, which is what the engine uses:
its CUDA graphs hold the pool tensors by address, so the pool is never
rebound.  ``leaves`` lists a cache tree's tensors in a fixed order.

``init_local_caches`` is ``init_caches`` for one rank of a serving mesh:
each leaf at the shape of this rank's shard under the reference's cache
specs (``models.transformer.cache_specs``: GQA's kv-head axis split when
the mesh divides it, MLA's latent leaves whole).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch


def _seed_leaf(dst: torch.Tensor, src: torch.Tensor,
               src_len: Optional[int]) -> torch.Tensor:
    """Copy of ``dst`` ([stack, batch, L, ...]) holding ``src``'s last
    min(src, L) positions, position p at index p mod L; ``src_len`` first
    clips the source to its first src_len positions (bucketed prefill:
    the tail is padding and never lands in a decode cache)."""
    if src_len is not None:
        src = src[:, :, :src_len]
    n, length = src.shape[2], dst.shape[2]
    ln = min(n, length)
    out = dst.clone()
    idx = torch.arange(n - ln, n, device=dst.device) % length
    out[:, :, idx] = src[:, :, n - ln:].to(dst.dtype)
    return out


def seed_decode_caches(cfg, caches, pf: Dict[str, torch.Tensor],
                       src_len: Optional[int] = None):
    """Prefill caches ``pf`` -> decode buffers shaped like ``caches``
    (from ``init_caches``); returns a new tree."""
    if cfg.family == "moe":
        parts = ([pf["dense"]] if cfg.first_dense_layers else []) + [pf["moe"]]
        pf = {f: torch.cat([part[f] for part in parts]) for f in parts[0]}
    elif cfg.family == "ssm":
        # the state is position-free; copied, as decode writes it in place
        return {f: pf[f].clone() for f in caches}
    elif cfg.family == "hybrid":
        return {kind: ({f: _seed_leaf(caches[kind][f], pf[kind][f], src_len)
                        for f in caches[kind]} if kind == "attn"
                       else {f: pf[kind][f].clone() for f in caches[kind]})
                for kind in caches}
    elif cfg.family == "audio":
        return {"self": {f: _seed_leaf(caches["self"][f], pf["self"][f],
                                       src_len) for f in caches["self"]},
                "cross_k": pf["cross_k"].to(caches["cross_k"].dtype,
                                            copy=True),
                "cross_v": pf["cross_v"].to(caches["cross_v"].dtype,
                                            copy=True)}
    elif cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(f"cache seeding for family "
                                  f"{cfg.family!r}")
    if "local" in caches:       # gemma2's pairs: layers 2i local, 2i+1 global
        return {kind: {f: _seed_leaf(caches[kind][f], pf[f][first::2],
                                     src_len) for f in caches[kind]}
                for kind, first in (("local", 0), ("global", 1))}
    return {f: _seed_leaf(caches[f], pf[f], src_len) for f in caches}


Tree = Union[torch.Tensor, Dict[str, "Tree"]]


def _slot_view(dst: torch.Tensor, src: torch.Tensor,
               slot: int) -> torch.Tensor:
    """The part of pool leaf ``dst`` that single-request leaf ``src`` fills:
    all of it when the shapes agree (one slot), else the index ``slot`` of
    the one axis where they differ."""
    if dst.shape == src.shape:
        return dst
    diff = [i for i, (a, b) in enumerate(zip(dst.shape, src.shape))
            if a != b]
    if dst.dim() != src.dim() or len(diff) != 1:
        raise ValueError(
            f"scatter_slot: cannot locate the slot axis between pool leaf "
            f"{tuple(dst.shape)} and single-request leaf {tuple(src.shape)} "
            f"(expected identical shapes except one axis)")
    return dst.narrow(diff[0], slot, 1)


def leaves(tree: Tree) -> List[torch.Tensor]:
    """A cache tree's tensors, depth first in key order."""
    if isinstance(tree, dict):
        return [leaf for name in tree for leaf in leaves(tree[name])]
    return [tree]


def _leaf_pairs(pool: Tree, single: Tree):
    if isinstance(pool, dict):
        return [pair for name in pool
                for pair in _leaf_pairs(pool[name], single[name])]
    return [(pool, single)]


def scatter_slot_(pool: Tree, single: Tree, slot: int) -> Tree:
    """Write ``single`` (a batch-1 cache tree) into batch index ``slot`` of
    ``pool`` **in place**, cast to the pool's dtypes; returns ``pool``.  A
    leaf pair whose shapes differ in rank or in more than one axis cannot
    come from one cache layout and raises ``ValueError`` before any leaf
    is written."""
    views = [(_slot_view(dst, src, slot), src)
             for dst, src in _leaf_pairs(pool, single)]
    for view, src in views:
        view.copy_(src)
    return pool


def scatter_slot(pool: Tree, single: Tree, slot: int) -> Tree:
    """``scatter_slot_`` on a copy: a new tree, ``pool`` left untouched (the
    reference's pure form)."""
    if isinstance(pool, dict):
        return {name: scatter_slot(pool[name], single[name], slot)
                for name in pool}
    return scatter_slot_(pool.clone(), single, slot)


def init_local_caches(cfg, batch: int, max_len: int, device="cuda",
                      mesh=None, rules=None, ring: bool = True) -> Tree:
    """``init_caches(cfg, batch, max_len, device, ring)``, each leaf cut to
    this rank's shard of ``mesh`` under ``rules`` (default
    ``SERVE_TP_RULES``); without a mesh, ``init_caches`` itself."""
    from repro_torch.models import init_caches
    if mesh is None:
        return init_caches(cfg, batch, max_len, device=device, ring=ring)
    from repro_torch.dist.api import SERVE_TP_RULES, make_shardings
    from repro_torch.models.transformer import cache_specs
    full = init_caches(cfg, batch, max_len, device="meta", ring=ring)
    shardings = make_shardings(cache_specs(full), mesh,
                               SERVE_TP_RULES if rules is None else rules,
                               shapes_tree=full)

    def build(t, sh):
        if isinstance(t, dict):
            return {name: build(t[name], sh[name]) for name in t}
        return torch.zeros(sh.shard_shape(t.shape), dtype=t.dtype,
                           device=device)

    return build(full, shardings)
