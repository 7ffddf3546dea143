"""Slot-based continuous-batching scheduler (a copy of
``repro.serve.scheduler``: pure bookkeeping, no framework).

The decode batch is a fixed pool of ``n_slots`` slots.  Queued requests are
admitted FCFS into whichever slots are free; a slot frees the moment its
request emits its last token, so the next queued request rides the very next
batched decode step instead of waiting for the whole batch to drain — the
difference between fixed-batch and continuous scheduling.

The scheduler is deliberately engine-agnostic: it only tracks slot ownership,
the arrival queue, and occupancy statistics, which makes it unit-testable
without touching a model.
"""

from __future__ import annotations

import collections
import heapq
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from repro_torch.serve.request import Request


class SlotScheduler:
    """FCFS admission of queued requests into freed decode slots.

    ``admit`` optionally takes a ``fits`` predicate for block-aware admission
    (the paged KV pool): the head of the queue is admitted only while the
    resource it needs is available — head-of-line blocking is deliberate, it
    preserves FCFS completion order.  ``preempt`` evicts an active request
    back to the *front* of the queue (paged pools preempt-to-queue when the
    free block list runs dry mid-decode); ``suspend`` does the same but tags
    the request as suspended-to-host — its KV state survives on the host and
    readmission resumes it instead of replaying from prefill.

    Free slots live in a min-heap (lowest slot id admitted first — the same
    deterministic order the historical sorted-list kept, without the
    O(n log n) re-sort on every release/preempt)."""

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError(f"need n_slots > 0, got {n_slots}")
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))
        heapq.heapify(self._free)
        self._queue: Deque[Request] = collections.deque()
        self._active: Dict[int, Request] = {}
        self._suspended_rids: Set[int] = set()
        self._occupancy: List[int] = []      # active-slot count per tick

    # ------------------------------------------------------------- admission

    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def admit(self, now: int,
              fits: Optional[Callable[[Request], bool]] = None,
              limit: Optional[int] = None) -> List[Tuple[int, Request]]:
        """Admit arrived requests into free slots; returns (slot, request).

        ``fits(req)`` gates each admission on resource availability (free KV
        blocks); admission stops at the first queued request that does not
        fit, keeping FCFS order.  ``limit`` caps admissions per call — a
        block-aware engine admits one at a time so each admission's
        allocation is visible to the next ``fits`` check."""
        admitted: List[Tuple[int, Request]] = []
        while self._free and self._queue and self._queue[0].arrival <= now:
            if limit is not None and len(admitted) >= limit:
                break
            if fits is not None and not fits(self._queue[0]):
                break
            slot = heapq.heappop(self._free)  # lowest free slot first
            req = self._queue.popleft()
            self._suspended_rids.discard(req.rid)
            self._active[slot] = req
            admitted.append((slot, req))
        return admitted

    def release(self, slot: int) -> None:
        if slot not in self._active:
            raise KeyError(f"slot {slot} is not active")
        del self._active[slot]
        heapq.heappush(self._free, slot)

    def preempt(self, slot: int) -> Request:
        """Evict ``slot``'s request back to the FRONT of the queue (it will
        restart from prefill on readmission) and free the slot."""
        if slot not in self._active:
            raise KeyError(f"slot {slot} is not active")
        req = self._active.pop(slot)
        heapq.heappush(self._free, slot)
        self._queue.appendleft(req)
        return req

    def suspend(self, slot: int) -> Request:
        """Preempt ``slot`` with suspend-to-host semantics: the request goes
        back to the FRONT of the queue, tagged so the engine resumes its
        swapped state on readmission instead of replaying from prefill."""
        req = self.preempt(slot)
        self._suspended_rids.add(req.rid)
        return req

    def is_suspended(self, rid: int) -> bool:
        return rid in self._suspended_rids

    # ------------------------------------------------------------------ state

    @property
    def active_slots(self) -> List[int]:
        return sorted(self._active)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def suspended(self) -> int:
        """Queued requests whose state is swapped to host (resume on admit)."""
        return len(self._suspended_rids)

    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    # ------------------------------------------------------------- statistics

    def record_occupancy(self) -> None:
        """Sample the active-slot count (call once per decode tick)."""
        self._occupancy.append(len(self._active))

    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step.

        Zero recorded ticks (a prefill-only trace where every request is
        satisfied by ``max_new_tokens <= 1`` never runs a decode step)
        reports 0.0 rather than dividing by zero."""
        if not self._occupancy:
            return 0.0
        return sum(self._occupancy) / (len(self._occupancy) * self.n_slots)
