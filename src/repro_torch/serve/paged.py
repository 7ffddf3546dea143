"""Paged KV-cache pool: block-table indirection for the serve engine
(counterpart of ``repro.serve.paged``).

Every attention-cache leaf is a pool of fixed-size blocks, GQA's
``{"k", "v"} [L, n_blocks, block_size, kv, hd]`` or MLA's latent
``{"ckv", "kpe"} [L, n_blocks, block_size, kv_lora | qk_rope_dim]`` (torch
tensors on the device; the leaves are found by probing ``init_caches``, so
any family's layout is taken as it is) and each
slot owns an int32 block table (host numpy) mapping logical position ``p``
to physical block ``table[slot, p // block_size]``.  Block 0 is the reserved
*trash* block: idle batch rows keep writing there, and a freed slot's table
resets to it.

Invariants (``check_invariants``):
  * a physical block is free XOR referenced by exactly one table;
  * table entries past a slot's owned prefix point at block 0, and no owned
    entry is free or trash — the fused kernel walks the table itself, so a
    table naming a freed or trash block would be a read-after-free;
  * freed blocks are reused lowest id first (the free list is a min-heap).

Refcounted sharing, copy-on-write, swap-to-host and speculative rollback
are not ported yet (they arrive with prefix caching and suspend/spec
serving).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import init_caches
from repro_torch.serve.cache import seed_decode_caches

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


class BlockPool:
    """Paged decode-cache pool with per-slot block tables.

    ``self.caches`` holds the device pools; the block table is host numpy
    (tiny, mutated every tick) and ships to the device per decode step."""

    def __init__(self, cfg, n_slots: int, max_len: int, block_size: int,
                 n_blocks: Optional[int] = None, device="cuda"):
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
        # plain-layout leaves are [L, batch, seq, ...]: the (batch, seq) axes
        # become (n_blocks, block_size)
        probe = init_caches(cfg, 1, 1, device="meta")
        self.caches: Dict[str, torch.Tensor] = {
            name: torch.zeros((leaf.shape[0], self.n_blocks, block_size)
                              + tuple(leaf.shape[3:]), dtype=leaf.dtype,
                              device=self.device)
            for name, leaf in probe.items()}
        self._staging = None                 # built lazily on first seed
        self.table = np.zeros((n_slots, self.table_width), np.int32)
        self._free: List[int] = list(range(1, self.n_blocks))
        heapq.heapify(self._free)
        self._owned: Dict[int, List[int]] = {s: [] for s in range(n_slots)}
        self.ref = np.zeros(self.n_blocks, np.int32)   # trash stays 0
        self.peak_blocks = 0

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
        return self.usable_blocks - len(self._free)

    @property
    def bytes_per_block(self) -> int:
        return sum(leaf.numel() * leaf.element_size() // self.n_blocks
                   for leaf in self.caches.values())

    # ------------------------------------------------------------ alloc/free

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, slot: int, n: int) -> bool:
        """Append n fresh blocks to ``slot``'s table; False if exhausted."""
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

    def ensure(self, slot: int, pos: int) -> bool:
        """Lazily append blocks until position ``pos`` is backed."""
        short = pos // self.block_size + 1 - len(self._owned[slot])
        if short <= 0:
            return True
        return self.alloc(slot, short)

    def free(self, slot: int) -> None:
        """Release every block ``slot`` holds; reset its table to trash."""
        for pid in self._owned[slot]:
            if pid == TRASH_BLOCK or self.ref[pid] != 1:
                raise ValueError(f"free: block {pid} of slot {slot} has "
                                 f"refcount {int(self.ref[pid])}")
            self.ref[pid] = 0
            heapq.heappush(self._free, pid)
        self._owned[slot] = []
        self.table[slot, :] = TRASH_BLOCK

    def write_block(self, slot: int, pos: int) -> int:
        """The physical block a decode write at ``pos`` would land in."""
        return int(self.table[slot, pos // self.block_size])

    def check_invariants(self, active_pos: Optional[Dict[int, int]] = None
                         ) -> None:
        """Raise if the pool bookkeeping is inconsistent (test/debug hook).

        Always checked: every block is free XOR referenced once by a table;
        each table row is its owner's blocks followed by trash; no owned
        entry is free or trash.  ``active_pos`` (slot -> decode position)
        also proves each active slot's read window [0, pos] is backed and
        its write block exclusive."""
        free = set(self._free)
        assert len(free) == len(self._free), "free heap holds duplicates"
        assert TRASH_BLOCK not in free, "trash block leaked into free heap"
        counts: Dict[int, int] = {}
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
                    f"table references")
        for s, pos in (active_pos or {}).items():
            need = self.blocks_for(pos + 1)
            assert need <= len(self._owned[s]), (
                f"slot {s} decoding at pos {pos} needs {need} blocks but "
                f"owns {len(self._owned[s])} — the kernel would walk into "
                f"trash")
            wb = self.write_block(s, pos)
            assert int(self.ref[wb]) == 1, (
                f"slot {s} is about to write position {pos} into block {wb} "
                f"with refcount {int(self.ref[wb])}")

    # --------------------------------------------------------------- seeding

    def make_staging(self) -> Dict[str, torch.Tensor]:
        """The batch-1 plain-layout zero template the prefill caches are
        seeded into before they are cut into blocks (built once)."""
        if self._staging is None:
            length = self.table_width * self.block_size
            self._staging = init_caches(self.cfg, 1, length,
                                        device=self.device)
        return self._staging

    def seed(self, slot: int, pf: Dict[str, torch.Tensor],
             n_positions: int) -> None:
        """Write the first ``n_positions`` positions of prefill caches ``pf``
        (batch 1) into ``slot``'s blocks, in place (whole blocks: the tail
        of the last one is zeros).  The table must already back them."""
        nb = self.blocks_for(n_positions)
        if nb > len(self._owned[slot]):
            raise RuntimeError(
                f"seed: slot {slot} owns {len(self._owned[slot])} blocks, "
                f"needs {nb} (admission must alloc before seeding)")
        staging = seed_decode_caches(self.cfg, self.make_staging(), pf,
                                     src_len=n_positions)
        pids = torch.as_tensor(self.table[slot, :nb], dtype=torch.long,
                               device=self.device)
        for name, pool in self.caches.items():
            sl = staging[name][:, 0]                       # [L, T*bs, ...]
            blocks = sl.reshape((sl.shape[0], self.table_width,
                                 self.block_size) + tuple(sl.shape[2:]))
            pool[:, pids] = blocks[:, :nb].to(pool.dtype)

    def device_table(self) -> torch.Tensor:
        return torch.tensor(self.table, device=self.device)
