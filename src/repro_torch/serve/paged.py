"""Paged KV-cache pool: block-table indirection for the serve engine
(counterpart of ``repro.serve.paged``).

Every attention-cache leaf is a pool of fixed-size blocks, GQA's
``{"k", "v"} [L, n_blocks, block_size, kv, hd]`` or MLA's latent
``{"ckv", "kpe"} [L, n_blocks, block_size, kv_lora | qk_rope_dim]`` (torch
tensors on the device; the leaves are found by probing ``init_caches``
with the window lifted, so any family's layout is taken as it is, and
gemma2's local layers share the one [L, ...] stack with its global ones:
their window is a read mask over the table).  A leaf whose shape does not
move with the probe's length has no sequence axis (an SSM state, a conv
tail): it stays **slot-indexed**, one row per slot on the axis where the
batch probe moved, and the cache tree keeps the family's nesting (the
hybrid's {"groups", "attn", "tail"}: only "attn" is paged).  Each
slot owns an int32 block table (host numpy) mapping logical position ``p``
to physical block ``table[slot, p // block_size]``.  Block 0 is the reserved
*trash* block: idle batch rows keep writing there, and a freed slot's table
resets to it.

Blocks are **refcounted**: ``alloc`` hands out fresh blocks at refcount 1,
``share`` appends *existing* live blocks to another slot's table (incref:
the prefix-cache hit path, where admission becomes a table write instead
of a prefill), ``incref`` / ``decref`` are the prefix index's pins, and
``free`` drops a slot's references, returning a block to the free heap only
when its last reference drops.  Writes never touch a shared block: ``cow``
copies a block with refcount > 1 onto a fresh block before the owner's next
write.  ``swap_out`` / ``swap_in`` move one slot's owned blocks to host
tensors and back, bit-exact: the suspend-to-host preemption path, whose
cost scales with resident bytes instead of prompt length.

The device side is written **in place**: the engine's CUDA graphs capture
the pool tensors by address and every replay checks their ``data_ptr()``s,
so ``seed``, ``cow`` (``pool[:, new].copy_(pool[:, old])``) and ``swap_in``
(an index put) update the pools without rebinding them, on the current
stream, the one the graphs replay on.  ``swap_out`` reads back
synchronously (``.cpu()``), so its blocks hold no pending read when they
return to the free heap.

Invariants (``check_invariants``):
  * a physical block is free XOR refcounted >= 1, and its refcount equals
    the table entries naming it plus its external references (the prefix
    index's pins, supplied by the engine);
  * table entries past a slot's owned prefix point at block 0, and no owned
    entry is free or trash; the fused kernel walks the table itself, so a
    table naming a freed or trash block would be a read-after-free;
  * **write-exclusivity**: every block an active slot writes this tick
    (its next position, or a speculative slot's whole span) has refcount 1;
  * freed blocks are reused lowest id first (the free list is a min-heap);
  * ``swap_out`` -> ``swap_in`` round-trips every block bit-exact.

Tensor-parallel serving (``mesh=``, ``rules=``): every leaf holds this
rank's shard under the reference's cache specs (GQA's kv-head axis split
where the mesh divides it; the block axes, MLA's latent leaves and the
table whole), so ``seed``, ``share``, ``cow``, ``swap_out`` and
``swap_in`` act on each rank's shard in place; the table stays host numpy
and every rank keeps the same one.

``rollback`` rewinds a slot's table after a speculative verify (the
rejected tail's blocks return to the free heap); it refuses a block whose
refcount is not 1, since the engine copies a shared span before any draft
write.  Slot-indexed leaves (``state``, one row per slot: SSM state, conv
tails) are written by ``seed`` (or zeroed by ``clear_state``) and ride
``swap_out`` / ``swap_in`` as the reference's do; the dense and MoE
families keep all their state behind the table, so their ``state`` is
empty.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.serve.cache import (init_local_caches, leaves,
                                     seed_decode_caches)

TRASH_BLOCK = 0


def default_buckets(max_len: int, lo: int = 4) -> Tuple[int, ...]:
    """Power-of-two prefill buckets up to (and always including) max_len."""
    out: List[int] = []
    b = lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


@dataclasses.dataclass
class SwapState:
    """One suspended slot's resident cache state, on the host.

    ``paged`` holds one ``[L, n_blocks, block_size, ...]`` tensor per paged
    leaf (the slot's owned blocks, in table order); ``state`` the slot's
    row of each slot-indexed leaf (its slot axis kept, of length 1).
    ``swap_in`` restores both bit-exact into freshly allocated blocks / the
    target slot's row."""

    n_blocks: int
    paged: List[torch.Tensor]
    state: List[torch.Tensor]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.paged + self.state)


class BlockPool:
    """Paged decode-cache pool with per-slot block tables.

    ``self.caches`` holds the device pools, in the family's cache tree
    (``paged`` lists its paged leaves, ``state`` its slot-indexed ones,
    ``state_axes`` their slot axes); the block table is host numpy (tiny,
    mutated every tick) and ships to the device per decode step."""

    def __init__(self, cfg, n_slots: int, max_len: int, block_size: int,
                 n_blocks: Optional[int] = None, device="cuda", mesh=None,
                 rules=None):
        if block_size <= 0:
            raise ValueError(f"need block_size > 0, got {block_size}")
        if n_slots <= 0:
            raise ValueError(f"need n_slots > 0, got {n_slots}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.table_width = -(-max_len // block_size)
        # default: full provisioning (every slot can hold max_len) + trash
        self.n_blocks = (n_blocks if n_blocks is not None
                         else n_slots * self.table_width + 1)
        if self.n_blocks < 2:
            raise ValueError("need at least 2 blocks (one is reserved trash)")
        self.mesh, self.rules = mesh, rules
        self.paged: List[torch.Tensor] = []
        self.state: List[torch.Tensor] = []
        self.state_axes: List[int] = []
        self.caches = self._layout(
            *(init_local_caches(cfg, b, n, "meta", mesh, rules, ring=False)
              for b, n in ((1, 1), (1, 2), (2, 1))))
        self._staging = None                 # built lazily on first seed
        self.table = np.zeros((n_slots, self.table_width), np.int32)
        self._free: List[int] = list(range(1, self.n_blocks))
        heapq.heapify(self._free)
        self._owned: Dict[int, List[int]] = {s: [] for s in range(n_slots)}
        self.ref = np.zeros(self.n_blocks, np.int32)   # trash stays 0
        self.peak_blocks = 0
        self.cow_copies = 0

    def _layout(self, one, longer, wider):
        """The pool tree from three probes of the plain layout (length 1,
        length 2, batch 2; windows lifted).  A leaf that moves with the
        length is [L, batch, seq, ...]: its (batch, seq) axes become
        (n_blocks, block_size).  Any other is slot-indexed: the axis that
        moves with the batch becomes ``n_slots``."""
        if isinstance(one, dict):
            return {name: self._layout(one[name], longer[name], wider[name])
                    for name in one}

        def moved(other):
            return [i for i, (x, y) in enumerate(zip(one.shape, other.shape))
                    if x != y]
        seq = moved(longer)
        if seq:
            if seq != [2]:
                raise ValueError(f"paged layout: a leaf with a sequence axis "
                                 f"must be [L, batch, seq, ...], got "
                                 f"{tuple(one.shape)} moving in {seq}")
            leaf = torch.zeros((one.shape[0], self.n_blocks, self.block_size)
                               + tuple(one.shape[3:]), dtype=one.dtype,
                               device=self.device)
            self.paged.append(leaf)
            return leaf
        (ax,) = moved(wider)
        shape = list(one.shape)
        shape[ax] = self.n_slots
        leaf = torch.zeros(shape, dtype=one.dtype, device=self.device)
        self.state.append(leaf)
        self.state_axes.append(ax)
        return leaf

    def _rows(self, slot: int):
        """(leaf, its row of ``slot``) of every slot-indexed leaf."""
        return [(leaf, leaf.narrow(ax, slot, 1))
                for leaf, ax in zip(self.state, self.state_axes)]

    # ------------------------------------------------------------ accounting

    def blocks_for(self, n_positions: int) -> int:
        return -(-max(n_positions, 0) // self.block_size)

    @property
    def usable_blocks(self) -> int:
        return self.n_blocks - 1             # minus the trash block

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Physical blocks with at least one live reference (a block shared
        by k tables still occupies one physical block)."""
        return self.usable_blocks - len(self._free)

    @property
    def bytes_per_block(self) -> int:
        return sum(leaf.numel() * leaf.element_size() // self.n_blocks
                   for leaf in self.paged)

    @property
    def state_bytes(self) -> int:
        """Bytes of the slot-indexed (non-paged) leaves."""
        return sum(leaf.numel() * leaf.element_size() for leaf in self.state)

    def resident_bytes(self) -> int:
        """KV bytes actually backing live requests (allocated blocks only)."""
        return self.used_blocks * self.bytes_per_block

    # ------------------------------------------------------------ alloc/free

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, slot: int, n: int) -> bool:
        """Append n fresh blocks (refcount 1) to ``slot``'s table; False if
        exhausted."""
        if len(self._free) < n:
            return False
        owned = self._owned[slot]
        if len(owned) + n > self.table_width:
            raise ValueError(
                f"slot {slot}: {len(owned) + n} blocks exceeds table width "
                f"{self.table_width} (max_len {self.max_len})")
        for _ in range(n):
            pid = heapq.heappop(self._free)
            self.ref[pid] = 1
            self.table[slot, len(owned)] = pid
            owned.append(pid)
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)
        return True

    def share(self, slot: int, pids: List[int]) -> None:
        """Append *existing live* blocks to ``slot``'s table (incref each):
        the prefix-cache hit path, where the new request's table points at
        blocks another owner (a slot or the prefix index) already holds, so
        the shared span costs a table write instead of a prefill."""
        owned = self._owned[slot]
        if len(owned) + len(pids) > self.table_width:
            raise ValueError(
                f"slot {slot}: sharing {len(pids)} blocks onto {len(owned)} "
                f"exceeds table width {self.table_width}")
        for pid in pids:
            if pid == TRASH_BLOCK or self.ref[pid] < 1:
                raise ValueError(
                    f"share: block {pid} is not live (ref "
                    f"{int(self.ref[pid])}) — sharing a freed block is a "
                    f"use-after-free")
            if pid in owned:
                raise ValueError(
                    f"share: slot {slot} already owns block {pid} — a table "
                    f"must not name a block twice")
            self.ref[pid] += 1
            self.table[slot, len(owned)] = pid
            owned.append(pid)

    def incref(self, pid: int) -> None:
        """Take an extra reference on a live block (prefix-index pinning)."""
        if pid == TRASH_BLOCK or self.ref[pid] < 1:
            raise ValueError(f"incref on non-live block {pid}")
        self.ref[pid] += 1

    def decref(self, pid: int) -> None:
        """Drop one reference; the block returns to the free heap at zero."""
        if pid == TRASH_BLOCK or self.ref[pid] < 1:
            raise ValueError(f"decref on non-live block {pid}")
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            heapq.heappush(self._free, pid)

    def ensure(self, slot: int, pos: int) -> bool:
        """Lazily append blocks until position ``pos`` is backed."""
        short = pos // self.block_size + 1 - len(self._owned[slot])
        if short <= 0:
            return True
        return self.alloc(slot, short)

    def free(self, slot: int) -> None:
        """Release every reference ``slot`` holds; reset its table to trash.
        Blocks shared with other tables (or the prefix index) stay
        resident."""
        for pid in self._owned[slot]:
            self.decref(pid)
        self._owned[slot] = []
        self.table[slot, :] = TRASH_BLOCK

    def rollback(self, slot: int, n_positions: int) -> None:
        """Rewind ``slot``'s table so only positions [0, n_positions) stay
        backed — the speculative reject path.  Blocks past the kept
        boundary return to the free heap; the boundary block stays (its
        stale tail is masked by position until the next write).  Every
        block to free must be exclusively owned (refcount 1); otherwise it
        raises before it changes anything."""
        owned = self._owned[slot]
        tail = owned[self.blocks_for(n_positions):]
        for pid in tail:
            if self.ref[pid] != 1:
                raise ValueError(
                    f"rollback: slot {slot} block {pid} has refcount "
                    f"{int(self.ref[pid])} — speculative spans must be "
                    f"exclusively owned")
        for pid in reversed(tail):
            owned.pop()
            self.table[slot, len(owned)] = TRASH_BLOCK
            self.decref(pid)

    # --------------------------------------------------------- copy-on-write

    def write_block(self, slot: int, pos: int) -> int:
        """The physical block a decode write at ``pos`` would land in."""
        return int(self.table[slot, pos // self.block_size])

    def needs_cow(self, slot: int, pos: int) -> bool:
        """True when the block backing ``pos`` is shared (refcount > 1):
        the owner must copy before its next write mutates it."""
        return self.ref[self.write_block(slot, pos)] > 1

    def cow(self, slot: int, pos: int) -> bool:
        """Copy-on-write the block backing ``pos`` for ``slot``: copy its
        device contents onto a fresh block (in place, per leaf), repoint the
        slot's table entry, and drop the reference on the shared original.
        No-op (True) when the block is already exclusive; False when no
        free block is available (the caller must evict or preempt first).
        The shared block itself is **never mutated**."""
        idx = pos // self.block_size
        old = int(self.table[slot, idx])
        if self.ref[old] <= 1:
            return True
        if not self._free:
            return False
        new = heapq.heappop(self._free)
        self.ref[new] = 1
        for pool in self.paged:
            pool[:, new].copy_(pool[:, old])
        self.table[slot, idx] = new
        self._owned[slot][idx] = new
        self.decref(old)
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)
        self.cow_copies += 1
        return True

    # ------------------------------------------------------- suspend-to-host

    def swap_out(self, slot: int) -> SwapState:
        """Copy ``slot``'s resident state to host tensors and release its
        block references: every owned block's contents per paged leaf (in
        table order) plus the slot's row of every slot-indexed leaf.  The
        read-back is synchronous, so the freed blocks can be handed out at
        once.  Preemption cost therefore scales with *resident bytes*, not
        prompt length."""
        owned = list(self._owned[slot])
        idx = torch.as_tensor(owned, dtype=torch.long, device=self.device)
        paged = [pool[:, idx].cpu() for pool in self.paged]
        # a copy also on the CPU, where .cpu() would return the live row
        state = [row.to("cpu", copy=True) for _, row in self._rows(slot)]
        self.free(slot)
        return SwapState(n_blocks=len(owned), paged=paged, state=state)

    def swap_in(self, slot: int, swap: SwapState) -> bool:
        """Restore a ``swap_out`` snapshot into ``slot``: allocate fresh
        blocks and write the host copies back bit-exact, in place.  False
        (nothing mutated) when the pool cannot back ``swap.n_blocks``
        blocks.  The target slot must be empty: the snapshot's block
        contents encode positions [0, n_blocks * block_size)."""
        if self._owned[slot]:
            raise ValueError(
                f"swap_in: slot {slot} already owns {len(self._owned[slot])} "
                f"blocks — restore needs an empty table")
        if not self.alloc(slot, swap.n_blocks):
            return False
        idx = torch.as_tensor(self._owned[slot], dtype=torch.long,
                              device=self.device)
        for pool, host in zip(self.paged, swap.paged):
            pool[:, idx] = host.to(self.device)
        for (_, row), host in zip(self._rows(slot), swap.state):
            row.copy_(host)
        return True

    def check_invariants(
            self, active_pos: Optional[Dict[int, Union[int, Tuple[int, int]]]]
            = None, external_refs: Optional[Dict[int, int]] = None) -> None:
        """Raise if the pool bookkeeping is inconsistent (test/debug hook).

        Always checked: every block is **free XOR refcounted >= 1**: a freed
        block has refcount 0 and a live block's refcount equals the table
        entries naming it plus its ``external_refs`` count (the prefix
        index's pins, supplied by the engine); each table row is its
        owner's blocks followed by trash; no owned entry is free or trash.
        ``active_pos`` maps a slot to its decode position ``pos``, or to the
        write window ``(pos, last)`` of a speculative span; it also proves
        each active slot's read window [0, last] is backed and every block
        of its write window exclusive (refcount 1: copy-on-write ran)."""
        free = set(self._free)
        assert len(free) == len(self._free), "free heap holds duplicates"
        assert TRASH_BLOCK not in free, "trash block leaked into free heap"
        counts: Dict[int, int] = dict(external_refs or {})
        for pid in counts:
            assert pid != TRASH_BLOCK and pid not in free, \
                f"external ref on freed/trash block {pid}"
        for s, owned in self._owned.items():
            assert len(set(owned)) == len(owned), \
                f"slot {s} table names a block twice"
            row = self.table[s]
            assert list(row[:len(owned)]) == owned, (s, row, owned)
            assert (row[len(owned):] == TRASH_BLOCK).all(), (s, row)
            for pid in owned:
                assert pid != TRASH_BLOCK, f"slot {s} owns the trash block"
                assert pid not in free, \
                    f"slot {s} table names freed block {pid} (read-after-free)"
                counts[pid] = counts.get(pid, 0) + 1
        assert int(self.ref[TRASH_BLOCK]) == 0, "trash block is refcounted"
        for pid in range(1, self.n_blocks):
            ref = int(self.ref[pid])
            if pid in free:
                assert ref == 0, f"free block {pid} has refcount {ref}"
                assert pid not in counts, \
                    f"free block {pid} is still referenced"
            else:
                assert ref >= 1, f"block {pid} leaked (not free, refcount 0)"
                assert ref == counts.get(pid, 0), (
                    f"block {pid} refcount {ref} != {counts.get(pid, 0)} "
                    f"live references (tables + external)")
        for s, window in (active_pos or {}).items():
            pos, last = window if isinstance(window, tuple) else (window,
                                                                  window)
            need = self.blocks_for(last + 1)
            assert need <= len(self._owned[s]), (
                f"slot {s} decoding at pos {last} needs {need} blocks but "
                f"owns {len(self._owned[s])} — the kernel would walk into "
                f"trash")
            bs = self.block_size
            for i in range(pos // bs, last // bs + 1):
                wb = int(self.table[s, i])
                assert int(self.ref[wb]) == 1, (
                    f"slot {s} is about to write positions [{pos}, {last}] "
                    f"into block {wb} with refcount {int(self.ref[wb])} — "
                    f"COW must copy first")

    # --------------------------------------------------------------- seeding

    def make_staging(self) -> Dict[str, torch.Tensor]:
        """The batch-1 plain-layout zero template the prefill caches are
        seeded into before they are cut into blocks (built once).  The
        window is lifted, as the reference's staging lifts it: a local
        layer's ring would be shorter than the table span."""
        if self._staging is None:
            length = self.table_width * self.block_size
            self._staging = init_local_caches(self.cfg, 1, length,
                                              self.device, self.mesh,
                                              self.rules, ring=False)
        return self._staging

    def seed(self, slot: int, pf, n_positions: int) -> None:
        """Write the first ``n_positions`` positions of prefill caches ``pf``
        (batch 1) into ``slot``'s blocks, in place (whole blocks: the tail
        of the last one is zeros), and the prefill's state into the slot's
        row of every slot-indexed leaf.  The table must already back the
        positions."""
        nb = self.blocks_for(n_positions)
        if nb > len(self._owned[slot]):
            raise RuntimeError(
                f"seed: slot {slot} owns {len(self._owned[slot])} blocks, "
                f"needs {nb} (admission must alloc before seeding)")
        staging = seed_decode_caches(self.cfg, self.make_staging(), pf,
                                     src_len=n_positions)
        pids = torch.as_tensor(self.table[slot, :nb], dtype=torch.long,
                               device=self.device)
        rows = iter(self._rows(slot))
        paged = {id(t) for t in self.paged}
        for pool, src in zip(leaves(self.caches), leaves(staging)):
            if id(pool) not in paged:
                next(rows)[1].copy_(src)
                continue
            sl = src[:, 0]                                 # [L, T*bs, ...]
            blocks = sl.reshape((sl.shape[0], self.table_width,
                                 self.block_size) + tuple(sl.shape[2:]))
            pool[:, pids] = blocks[:, :nb].to(pool.dtype)

    def clear_state(self, slot: int) -> None:
        """Zero ``slot``'s row of every slot-indexed leaf, in place: the
        state of an empty prompt, from which a prompt decodes entirely
        through forced tokens."""
        for _, row in self._rows(slot):
            row.zero_()

    def device_table(self) -> torch.Tensor:
        return torch.tensor(self.table, device=self.device)
