"""Host-side radix (trie) index over cached KV prefixes (a copy of
``repro.serve.prefix``: pure Python, no framework).

The paged pool (``serve.paged.BlockPool``) makes KV memory nameable through
per-slot block tables; this module makes it **findable**: when a request
retires, the engine registers its prompt tokens together with the block id
backing each position, and admission matches an incoming token prompt
against the trie.  A hit means the shared span's K/V is already resident on
the card: the new slot's table simply points at the cached blocks
(``BlockPool.share``, one incref per block) and only the divergent suffix
is replayed, through forced decode ticks.  This is the paper's indirection
move applied across *requests*: one physical block nameable by many
tables, as one vector register row is nameable by many index-stream
entries in vindexmac.

Structure: a radix tree with token-sequence edge labels (paths are
compressed; an edge splits when a new sequence diverges inside it).  Each
node stores, per token on its edge, the physical block id backing that
position (block ids repeat ``block_size`` times).  Matching walks edges
token-by-token and may stop mid-edge, so hits are **token-granular**: a
prefix that ends inside a block shares that block partially, and the first
divergent write triggers copy-on-write in the pool.

Refcounting contract: **a node holds one pool reference per distinct block
id on its edge** (taken at node creation, dropped at eviction).  A block
spanning a node split ends up referenced by both halves; refcounts make
that safe, and it keeps the bookkeeping local: no node ever needs to know
what the rest of the trie pins.  Eviction removes the least-recently-used
*leaf* node (``evict_lru``) so interior nodes, the shared short prefixes,
outlive their rarely-reused extensions; the eviction loop must be handed
the node it is making room for (``protect=``), since ancestors of a live
node can never become leaves but the match node itself could.

Boundary-block rule: when a match crosses a radix-node boundary *inside*
one block-size span (prompt ``X+A`` retired, then ``X+B`` with
``len(X) % block_size != 0``), the span's per-token pids straddle two
branches that name *different physical copies* of the same logical block
(the later branch copied it on write before diverging).  The engine must
share the pid recorded at the span's **last matched position**: that is the
later branch's copy holding the full matched history, while the earlier
positions' pid holds the older branch's divergent suffix past the
boundary.  A hit ending mid-block then still lands the new slot's first
decode write in a shared block, so ``BlockPool.cow`` runs before that
write (the pool's write-exclusivity invariant, ``serve/paged.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    """One radix-tree node: ``key`` is the token edge-label into this node,
    ``pids[i]`` the physical block backing ``key[i]``'s position."""

    __slots__ = ("key", "pids", "children", "parent", "last_used")

    def __init__(self, key: List[int], pids: List[int],
                 parent: Optional["_Node"], last_used: int):
        self.key = key
        self.pids = pids
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.last_used = last_used


class PrefixIndex:
    """Radix trie over cached token prefixes -> per-position block ids.

    The index *pins* the blocks it names (one ``BlockPool.incref`` per
    distinct block id per node), so a cached prefix stays resident after its
    request retires until ``evict_lru`` releases it under memory pressure.
    """

    def __init__(self):
        self._root = _Node([], [], None, -1)
        self.nodes = 0                       # non-root node count

    # -------------------------------------------------------------- matching

    def match(self, tokens: Sequence[int], now: int
              ) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: returns ``(m, pids)`` where
        ``pids[i]`` backs position ``i`` for ``i < m``.  Touches every node
        on the match path (LRU protection).  Hit accounting lives in the
        engine (``ServeEngine.prefix_hits``) — match runs more than once per
        admission (fits-gate + admission), so a counter here would lie."""
        m, pids, _ = self.match_path(tokens, now)
        return m, pids

    def match_path(self, tokens: Sequence[int], now: int
                   ) -> Tuple[int, List[int], Optional[_Node]]:
        """``match`` plus the deepest node on the match path (None when
        ``m == 0``).  Callers hand that node to ``evict_lru(protect=...)``
        so the eviction loop cannot drop the very match it is making room
        for (its ancestors cannot become leaves while it lives, so pinning
        the deepest node pins the whole path)."""
        tokens = [int(t) for t in tokens]
        node, m, pids = self._root, 0, []
        deepest: Optional[_Node] = None
        while m < len(tokens):
            child = node.children.get(tokens[m])
            if child is None:
                break
            i = 0
            while (i < len(child.key) and m + i < len(tokens)
                   and child.key[i] == tokens[m + i]):
                i += 1
            child.last_used = now
            pids.extend(child.pids[:i])
            m += i
            deepest = child
            if i < len(child.key):           # diverged (or ran out) mid-edge
                break
            node = child
        return m, pids, deepest

    # ------------------------------------------------------------- insertion

    def insert(self, tokens: Sequence[int], pids: Sequence[int], now: int,
               pool) -> bool:
        """Register ``tokens`` (position ``i`` backed by block ``pids[i]``)
        in the trie, pinning newly covered blocks via ``pool.incref``.
        Spans already cached are left as-is (first writer wins — the
        resident blocks are interchangeable bit-exact copies).  Returns True
        if any new span was added."""
        tokens = [int(t) for t in tokens]
        pids = [int(p) for p in pids]
        if len(tokens) != len(pids):
            raise ValueError(f"insert: {len(tokens)} tokens vs {len(pids)} "
                             f"block ids")
        node, i = self._root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                new = _Node(tokens[i:], pids[i:], node, now)
                node.children[tokens[i]] = new
                for pid in set(new.pids):
                    pool.incref(pid)
                self.nodes += 1
                return True
            j = 0
            while (j < len(child.key) and i < len(tokens)
                   and child.key[j] == tokens[i]):
                j += 1
                i += 1
            child.last_used = now
            if j < len(child.key):
                if i >= len(tokens):
                    return False             # fully covered mid-edge
                self._split(child, j, pool)  # diverged mid-edge: split, then
                node = child                 # the next loop pass adds a child
            else:
                node = child
        return False

    def _split(self, child: _Node, j: int, pool) -> None:
        """Split ``child``'s edge at offset ``j``: the tail becomes a new
        node below it.  Reference bookkeeping follows the per-node rule —
        the tail increfs its distinct blocks, the head drops blocks it no
        longer names (incref first, so a boundary-spanning block never
        transits through refcount 0)."""
        head, tail_k = child.key[:j], child.key[j:]
        head_p, tail_p = child.pids[:j], child.pids[j:]
        tail = _Node(tail_k, tail_p, child, child.last_used)
        for pid in set(tail_p):
            pool.incref(pid)
        for pid in set(child.pids) - set(head_p):
            pool.decref(pid)
        tail.children, child.children = child.children, {tail_k[0]: tail}
        for grand in tail.children.values():
            grand.parent = tail
        child.key, child.pids = head, head_p
        self.nodes += 1

    # -------------------------------------------------------------- eviction

    def evict_lru(self, pool, protect: Sequence[_Node] = ()) -> bool:
        """Drop the least-recently-used *leaf* node, releasing its block
        pins.  Nodes in ``protect`` are exempt — the engine pins the deepest
        node of an in-flight admission's match path, whose ancestors cannot
        become leaves while it lives, so the whole matched path survives the
        eviction loop that is making room for it.  Returns False when
        nothing evictable is left (empty trie, or only protected leaves)."""
        victim: Optional[_Node] = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n in protect:
                continue
            elif victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return False
        victim.parent.children.pop(victim.key[0])
        for pid in set(victim.pids):
            pool.decref(pid)
        self.nodes -= 1
        return True

    # ------------------------------------------------------------ accounting

    def block_refs(self) -> Dict[int, int]:
        """pid -> number of references this index holds (for
        ``BlockPool.check_invariants(external_refs=)``)."""
        refs: Dict[int, int] = {}
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            for pid in set(n.pids):
                refs[pid] = refs.get(pid, 0) + 1
        return refs

    @property
    def blocks(self) -> int:
        """Distinct physical blocks the index pins."""
        return len(self.block_refs())

    @property
    def cached_tokens(self) -> int:
        """Total token positions resident in the trie."""
        total, stack = 0, list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            total += len(n.key)
        return total
