"""Port parity for prefix caching, copy-on-write and suspend-to-host
preemption: ``repro_torch.serve.prefix``, the refcounted ``BlockPool``
(``share`` / ``cow`` / ``swap_out`` / ``swap_in``) and the engine's
``prefix_cache=True`` / ``preempt="suspend"``, after the reference's
``tests/test_prefix.py`` (its slotted, SSM and gemma2 cases are left out:
the port lacks those layouts and families).

* ``PrefixIndex``: the port's and the reference's index run one random op
  sequence; match results, pids, ``block_refs`` and evictions are equal.
* ``BlockPool``: random alloc / free / share / cow / swap sequences (numpy,
  seeded) leave the port's table, refcounts and free heap equal to the
  reference pool's after every op; COW and the swap round trip are
  bit-exact on the pool tensors and write them in place.
* The engine, llama3.2-1b (compressed) and deepseek-v2-lite-16b smoke (f32,
  the reference's weights carried over), with ``prefix_cache=True``, with
  ``preempt="suspend"``, with both, and with ``spec=`` plus the prefix
  cache: tokens and the prefix / swap counters equal the reference
  engine's under the same flags, and the port's prefix run emits its
  non-sharing run's tokens.
* The regression cases: a hit across a radix-node boundary, the admission
  back-out, eviction unblocking admission, preemption mid-catch-up in both
  modes, the index pinning its blocks after the trace drains, the CLI.
Every engine runs on the CPU with ``debug_invariants=True``."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.serve import BlockPool as JBlockPool  # noqa: E402
from repro.serve import PrefixIndex as JPrefixIndex  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpecConfig as JSpec  # noqa: E402
from repro.serve import shared_prefix_trace as jprefix_trace  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import from_reference_params  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import (BlockPool, PrefixIndex, Request,  # noqa: E402
                               ServeEngine, SlotScheduler, SpecConfig,
                               shared_prefix_trace, synthetic_request,
                               synthetic_trace)

LLAMA, DEEPSEEK = "llama3.2-1b", "deepseek-v2-lite-16b"
_PAIRS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """Smoke-size tensors gain nothing from intra-op threads, which spin on
    every core while the suite's other workers share them: this file's
    torch ops run on one thread (restored after each test)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(arch):
    """(reference cfg, reference params, port cfg, port model): smoke size,
    f32, the same weights in both."""
    if arch not in _PAIRS:
        jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
        params = jax.jit(lambda k: jinit(k, jc)[0])(jax.random.PRNGKey(0))
        model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                      device="cpu")
        _PAIRS[arch] = (jc, params, tc, model)
    return _PAIRS[arch]


def _tokens(results):
    return {rid: r.tokens.tolist() for rid, r in results.items()}


# ---------------------------------------------------------------- PrefixIndex

class _FakePool:
    """The refcount side of a pool, to check the trie's contract alone (one
    pool reference per distinct block id per node)."""

    def __init__(self):
        self.ref = {}

    def seed_refs(self, pids):
        for p in set(pids):
            self.ref[p] = self.ref.get(p, 0) + 1

    def incref(self, pid):
        if self.ref.get(pid, 0) < 1:
            raise ValueError(f"incref on non-live block {pid}")
        self.ref[pid] += 1

    def decref(self, pid):
        if self.ref.get(pid, 0) < 1:
            raise ValueError(f"decref on non-live block {pid}")
        self.ref[pid] -= 1


def _node_view(node):
    return None if node is None else (node.key, node.pids, node.last_used)


@pytest.mark.parametrize("seed", range(6))
def test_prefix_index_equals_reference_under_random_ops(seed):
    """Retirements (insert a prompt whose leading blocks are a match's, as
    a hit's are), matches and LRU evictions (half of them protecting a
    match path), over a 3-token alphabet so edges split often: every
    result and every refcount equals the reference index's."""
    rng = np.random.default_rng(seed)
    idx, ref = PrefixIndex(), JPrefixIndex()
    pool, ref_pool = _FakePool(), _FakePool()
    nxt, bs = 1, 2
    for now in range(60):
        kind = int(rng.integers(0, 3))
        toks = rng.integers(0, 3, int(rng.integers(1, 9))).tolist()
        m, pids, node = idx.match_path(toks, now)
        rm, rpids, rnode = ref.match_path(toks, now)
        assert (m, pids, _node_view(node)) == (rm, rpids, _node_view(rnode))
        if kind == 0:                      # a request retires
            keep = (m // bs) * bs if rng.integers(0, 2) else 0
            fresh = [nxt + i // bs for i in range(len(toks) - keep)]
            nxt += len(toks)
            held = pids[:keep] + fresh
            pool.seed_refs(held), ref_pool.seed_refs(held)
            assert idx.insert(toks, held, now, pool) == ref.insert(
                toks, held, now, ref_pool)
            for p in set(held):            # the slot drops its references
                pool.decref(p), ref_pool.decref(p)
        elif kind == 1:                    # evict, maybe around a match
            protect = (node,) if node is not None and rng.integers(0, 2) \
                else ()
            assert idx.evict_lru(pool, protect=protect) == ref.evict_lru(
                ref_pool, protect=(rnode,) if protect else ())
        assert idx.block_refs() == ref.block_refs()
        assert (idx.nodes, idx.blocks, idx.cached_tokens) == (
            ref.nodes, ref.blocks, ref.cached_tokens)
        assert pool.ref == ref_pool.ref
    while idx.evict_lru(pool):
        assert ref.evict_lru(ref_pool)
    assert not ref.evict_lru(ref_pool) and idx.block_refs() == {}
    assert pool.ref == ref_pool.ref and not any(pool.ref.values())


def test_prefix_index_split_keeps_boundary_block_refcounted():
    """A block spanning the split point ends up pinned by both halves and
    never passes through refcount 0 (the fake pool raises if it does)."""
    idx, pool = PrefixIndex(), _FakePool()
    pool.seed_refs([5, 5, 6, 6])
    idx.insert([1, 2, 3, 4], [5, 5, 6, 6], now=0, pool=pool)
    pool.seed_refs([5, 5, 6, 7])
    idx.insert([1, 2, 3, 9], [5, 5, 6, 7], now=1, pool=pool)
    assert idx.nodes == 3
    assert idx.block_refs() == {5: 1, 6: 2, 7: 1}
    assert idx.match([1, 2, 3, 4], now=2) == (4, [5, 5, 6, 6])
    assert idx.match([1, 2, 3, 9], now=3) == (4, [5, 5, 6, 7])


def test_prefix_index_protect_pins_match_path_against_eviction():
    """``evict_lru(protect=)`` skips the pinned leaf even when it is the
    LRU minimum, and returns False rather than evict it."""
    idx, pool = PrefixIndex(), _FakePool()
    pool.seed_refs([5, 5, 6]), pool.seed_refs([5, 5, 7])
    idx.insert([1, 2, 3], [5, 5, 6], now=0, pool=pool)
    idx.insert([1, 2, 4], [5, 5, 7], now=1, pool=pool)
    m, pids, node = idx.match_path([1, 2, 4], now=2)
    assert (m, pids) == (3, [5, 5, 7])
    node.last_used = -5
    assert idx.evict_lru(pool, protect=(node,))
    assert idx.match([1, 2, 4], now=3)[0] == 3
    assert idx.match([1, 2, 3], now=4)[0] == 2
    assert not idx.evict_lru(pool, protect=(node,))
    assert idx.evict_lru(pool)


# --------------------------------------------------- BlockPool refcounts/COW

def _pools(n_slots=3, max_len=16, block_size=4, n_blocks=8):
    jc, _, tc, _ = _pair(LLAMA)
    return (BlockPool(tc, n_slots, max_len, block_size, n_blocks,
                      device="cpu"),
            JBlockPool(jc, n_slots, max_len, block_size, n_blocks))


def _same_books(p, q):
    np.testing.assert_array_equal(p.table, q.table)
    np.testing.assert_array_equal(p.ref, q.ref)
    assert p._free == q._free and p._owned == q._owned
    assert (p.cow_copies, p.peak_blocks) == (q.cow_copies, q.peak_blocks)


@pytest.mark.parametrize("seed", range(6))
def test_pool_books_equal_reference_under_random_share_cow_swap(seed):
    """Alloc, free, share, cow and swap round trips in a random order (the
    reference's property test, drawn from a seeded generator): after every
    op the port's table, refcounts, owned lists and free heap equal the
    reference pool's, and both pass ``check_invariants``."""
    rng = np.random.default_rng(seed)
    p, q = _pools()
    swaps = {}
    for _ in range(30):
        kind, slot, arg = (int(rng.integers(0, 5)), int(rng.integers(0, 3)),
                           int(rng.integers(0, 8)))
        if kind == 0:
            n = arg % (p.table_width - len(p._owned[slot]) + 1)
            assert p.alloc(slot, n) == q.alloc(slot, n)
        elif kind == 1:
            p.free(slot), q.free(slot)
        elif kind == 2:                    # share a live block of another slot
            donors = [pid for s, o in p._owned.items() if s != slot
                      for pid in o if pid not in p._owned[slot]]
            if donors and len(p._owned[slot]) < p.table_width:
                pid = donors[arg % len(donors)]
                p.share(slot, [pid]), q.share(slot, [pid])
        elif kind == 3:                    # cow the slot's last block
            if p._owned[slot]:
                pos = (len(p._owned[slot]) - 1) * p.block_size
                assert p.needs_cow(slot, pos) == q.needs_cow(slot, pos)
                assert p.cow(slot, pos) == q.cow(slot, pos)
        elif slot in swaps and not p._owned[slot]:
            a, b = swaps.pop(slot)
            assert p.swap_in(slot, a) == q.swap_in(slot, b)
        elif slot not in swaps and p._owned[slot]:
            swaps[slot] = (p.swap_out(slot), q.swap_out(slot))
            assert swaps[slot][0].nbytes == swaps[slot][1].nbytes
        _same_books(p, q)
        p.check_invariants()
        q.check_invariants()


def _fill(p, seed):
    g = torch.Generator().manual_seed(seed)
    for leaf in p.caches.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype))


def test_cow_copies_shared_block_in_place_and_bit_exact():
    p, _ = _pools(n_slots=2, max_len=8, n_blocks=None)
    _fill(p, 1)
    ptrs = [t.data_ptr() for t in p.caches.values()]
    assert p.alloc(0, 1)
    old = p._owned[0][0]
    assert p.cow(0, 2) and p.cow_copies == 0     # exclusive: a no-op
    p.share(1, [old])
    assert p.needs_cow(1, 0) and p.cow(1, 0)
    new = p._owned[1][0]
    assert new != old and p.cow_copies == 1
    assert int(p.ref[old]) == int(p.ref[new]) == 1
    for leaf in p.caches.values():
        assert torch.equal(leaf[:, new], leaf[:, old])
    assert [t.data_ptr() for t in p.caches.values()] == ptrs
    p.check_invariants(active_pos={0: 0, 1: 0})


def test_swap_round_trip_is_bit_exact_and_in_place():
    p, _ = _pools(n_slots=2, max_len=16, n_blocks=None)
    _fill(p, 3)
    ptrs = [t.data_ptr() for t in p.caches.values()]
    assert p.alloc(0, 3)
    before = [leaf[:, p._owned[0]].clone() for leaf in p.caches.values()]
    swap = p.swap_out(0)
    assert swap.n_blocks == 3 and p.free_blocks == p.usable_blocks
    assert swap.nbytes == 3 * p.bytes_per_block and swap.state == []
    _fill(p, 4)                            # the freed blocks get overwritten
    assert p.swap_in(1, swap)              # into another slot
    p.check_invariants()
    for b, leaf in zip(before, p.caches.values()):
        assert torch.equal(leaf[:, p._owned[1]], b)
    assert [t.data_ptr() for t in p.caches.values()] == ptrs


def test_swap_in_false_when_pool_cannot_back_it():
    p, _ = _pools(n_slots=2, max_len=16, n_blocks=4)  # 3 usable
    assert p.alloc(0, 3)
    swap = p.swap_out(0)
    assert p.alloc(1, 1)
    assert not p.swap_in(0, swap)
    p.check_invariants()
    p.free(1)
    assert p.swap_in(0, swap)
    p.check_invariants()


def test_share_guards_and_external_refs():
    p, _ = _pools(n_slots=2, max_len=8, n_blocks=None)
    assert p.alloc(0, 1)
    pid = p._owned[0][0]
    with pytest.raises(ValueError, match="twice"):
        p.share(0, [pid])
    p.share(1, [pid])
    with pytest.raises(AssertionError, match="COW"):
        p.check_invariants(active_pos={1: 0})
    p.incref(pid)                          # a prefix-index pin
    with pytest.raises(AssertionError, match="refcount"):
        p.check_invariants()
    p.check_invariants(external_refs={pid: 1})
    p.free(0), p.free(1)
    assert int(p.ref[pid]) == 1            # the pin keeps it resident
    p.share(1, [pid])
    with pytest.raises(ValueError, match="rollback"):
        p.rollback(1, 0)                   # a shared tail is never freed
    p.free(1)
    p.decref(pid)
    with pytest.raises(ValueError, match="use-after-free"):
        p.share(1, [pid])
    with pytest.raises(ValueError, match="non-live"):
        p.decref(pid)
    p.check_invariants()


def test_scheduler_suspend_tags_and_admit_clears():
    sched = SlotScheduler(1)
    sched.submit(Request(rid=7, inputs={}, max_new_tokens=1))
    [(slot, _)] = sched.admit(now=0)
    sched.suspend(slot)
    assert sched.is_suspended(7) and sched.suspended == 1
    [(slot, req)] = sched.admit(now=0)
    assert req.rid == 7 and not sched.is_suspended(7)


# --------------------------------------------------------- engine: parity

STAT_KEYS = ("tokens", "ticks", "decode_steps", "prefill_calls",
             "preemptions", "prefix_hits", "prefix_hit_tokens", "cow_copies",
             "swap_outs", "swap_ins", "swap_bytes_resident",
             "index_evictions", "index_blocks", "index_tokens",
             "kv_bytes_resident", "kv_state_bytes")
SPEC_KEYS = ("spec_proposed", "spec_accepted", "spec_steps_saved",
             "draft_steps")
# one shared-prefix trace for every case: prompts of 8 = one of two 6-token
# system prompts + 2, so a hit ends inside the second block of 4 (COW);
# prefill buckets (4, 8) keep the reference's compiles few
TRACE = dict(n_requests=8, prefix_len=6, suffix_len=2, gen_lens=[3, 5],
             seed=1, n_prefixes=2)
BASE = dict(n_slots=2, max_len=16, block_size=4, prefill_buckets=(4, 8))
# 6 usable blocks for two slots of up to 3 blocks each, and the index's
# pins on top: the pool runs dry mid-decode
TIGHT = dict(BASE, n_slots=3, n_blocks=7)
CASES = {
    "prefix": dict(BASE, prefix_cache=True),
    "suspend": dict(TIGHT, preempt="suspend"),
    "prefix_suspend": dict(TIGHT, prefix_cache=True, preempt="suspend"),
    "spec_prefix": dict(BASE, prefix_cache=True, spec=2),
}
_RUNS = {}


def _kw(arch, flags, port: bool):
    kw = dict(flags)
    draft = "rerank" if arch == LLAMA else "skip"
    if "spec" in kw:
        k = kw.pop("spec")
        kw["spec"] = (SpecConfig if port else JSpec)(k=k, draft=draft)
    # deepseek serves its masked weights: the reference's compression of
    # the expert stacks would take most of this file's time
    kw["compressed"] = arch == LLAMA
    return kw


def _port_run(arch, flags, reqs=None):
    _, _, tc, model = _pair(arch)
    eng = ServeEngine(model, tc, kv="paged", attn="fused",
                      debug_invariants=True,
                      device="cpu", **_kw(arch, flags, True))
    eng.run(reqs or shared_prefix_trace(tc, **TRACE))
    eng.check_invariants()
    return eng


def _ref_run(arch, flags):
    jc, params, _, _ = _pair(arch)
    eng = JEngine(params, jc, kv="paged", attn="gather",
                  **_kw(arch, flags, False))
    eng.run(jprefix_trace(jc, **TRACE))
    return eng


def _cached(arch, case):
    if (arch, case) not in _RUNS:
        flags = CASES.get(case) or {"base": BASE, "tight": TIGHT}[case]
        _RUNS[arch, case] = _port_run(arch, flags)
    return _RUNS[arch, case]


# deepseek's reference engines compile slowly: its one reference case
# turns both features on (hits, COW, evictions and swaps of the MLA pools
# in one run); its speculative case is held against the port's own runs
@pytest.mark.parametrize("arch,case", [(LLAMA, c) for c in CASES] + [
    (DEEPSEEK, "prefix_suspend")])
def test_engine_equals_reference_under_same_flags(arch, case):
    """Tokens and every prefix / swap counter equal the reference engine's
    under the same flags, and the tokens equal the port's non-sharing
    replay run's (the sharing and suspending runs change where K/V comes
    from, never what it is)."""
    eng, ref = _cached(arch, case), _ref_run(arch, CASES[case])
    assert _tokens(eng.results) == _tokens(ref.results)
    st, js = eng.stats(), ref.stats()
    keys = STAT_KEYS + (SPEC_KEYS if "spec" in CASES[case] else ())
    assert {k: st[k] for k in keys} == {k: js[k] for k in keys}
    plain = _cached(arch, "tight" if "n_blocks" in CASES[case] else "base")
    assert _tokens(eng.results) == _tokens(plain.results)
    if CASES[case].get("prefix_cache"):
        assert st["prefix_hits"] > 0 and st["cow_copies"] > 0
        assert st["prefill_calls"] + st["prefix_hits"] == (
            TRACE["n_requests"] + st["preemptions"] - st["swap_ins"])
        assert eng.pool.used_blocks == st["index_blocks"] > 0
    if CASES[case].get("preempt") == "suspend":
        assert st["preemptions"] > 0
        assert st["swap_outs"] == st["swap_ins"] == st["preemptions"]
        assert st["swap_bytes_resident"] == 0
    if case == "suspend":                  # no emitted token is recomputed
        assert st["ticks"] <= plain.stats()["ticks"]
    if "spec" in CASES[case]:
        assert st["spec_proposed"] > 0


def test_strict_prewarm_serves_prefix_and_suspend_with_no_capture():
    """The shape set does not change: a hit's catch-up runs through the
    decode entry, copies and swaps run between forwards, so a strict
    prewarmed engine (any mid-serve capture raises) serves the tight
    trace with the tokens of the lazy engine."""
    _, _, tc, model = _pair(LLAMA)
    kw = _kw(LLAMA, CASES["prefix_suspend"], True)
    eng = ServeEngine(model, tc, kv="paged", attn="fused", device="cpu",
                      prewarm=True, strict_prewarm=True,
                      debug_invariants=True, **kw)
    eng.run(shared_prefix_trace(tc, **TRACE))
    lazy = _cached(LLAMA, "prefix_suspend")
    st = eng.stats()
    assert _tokens(eng.results) == _tokens(lazy.results)
    assert st["mid_serve_compiles"] == 0
    assert st["prefix_hits"] > 0 and st["swap_outs"] > 0
    assert eng.executable_shapes() == ServeEngine(
        model, tc, kv="paged", device="cpu", **_kw(LLAMA, TIGHT, True)
    ).executable_shapes()


def test_mla_spec_prefix_engine_equals_plain_run():
    """deepseek's verify span over shared latent blocks: with ``spec=`` and
    the prefix cache the whole k+1 span is copied before any draft write,
    so rollback frees only exclusive blocks, and the tokens equal the
    port's non-sharing, non-speculative run's."""
    eng = _cached(DEEPSEEK, "spec_prefix")
    st = eng.stats()
    assert _tokens(eng.results) == _tokens(_cached(DEEPSEEK, "base").results)
    assert st["prefix_hits"] > 0 and st["cow_copies"] > 0
    assert st["spec_proposed"] > 0
    assert eng.pool.used_blocks == st["index_blocks"] > 0


# ------------------------------------------------------ engine: regressions

def test_prefix_hit_across_node_boundary_takes_the_latest_branch_block():
    """X+A retires, X+B retires (len(X) % block_size != 0, so the trie
    splits mid-block), then X+B again: its match crosses the X|B node
    boundary inside one block span and must share node B's copy-on-write
    block (the last matched position's), never node X's block, whose
    position 6 holds A's K/V."""
    _, _, tc, _ = _pair(LLAMA)
    rng = np.random.default_rng(13)
    X = rng.integers(0, tc.vocab, (6,)).astype(np.int32)
    A = rng.integers(0, tc.vocab, (2,)).astype(np.int32)
    B = ((A + 1) % tc.vocab).astype(np.int32)
    reqs = [Request(0, {"tokens": np.concatenate([X, A])}, 3),
            Request(1, {"tokens": np.concatenate([X, B])}, 3),
            Request(2, {"tokens": np.concatenate([X, B])}, 4)]
    kw = dict(n_slots=1, max_len=16, block_size=4, n_blocks=10,
              prefill_buckets=(4, 8))
    base = _port_run(LLAMA, kw, [dataclasses.replace(r) for r in reqs])
    eng = _port_run(LLAMA, dict(kw, prefix_cache=True), reqs)
    st = eng.stats()
    assert st["prefix_hits"] == 2 and st["prefix_hit_tokens"] == 6 + 7
    assert _tokens(eng.results) == _tokens(base.results)
    probe = Request(3, {"tokens": np.concatenate([X, B])}, 2)
    _, pids = eng.index.match(np.concatenate([X, B])[:7], now=99)
    m, blocks, node = eng._match(probe, now=99)
    assert m == 7 and node is not None
    assert pids[4] != pids[6], "the trace no longer crosses a node " \
                               "boundary mid-block"
    assert blocks == [pids[3], pids[6]]


def test_admission_backs_out_when_fits_match_disappears():
    """When the match that let the fits-gate reserve one block is gone at
    allocation time, admission requeues the request (back-out) instead of
    failing; the race is a one-shot phantom match seen by the gate only."""
    _, _, tc, model = _pair(LLAMA)
    rng = np.random.default_rng(17)
    reqs = [synthetic_request(tc, rng, rid=0, prompt_len=8,
                              max_new_tokens=5),
            synthetic_request(tc, rng, rid=1, prompt_len=9,
                              max_new_tokens=2)]
    kw = dict(n_slots=2, max_len=16, block_size=4, n_blocks=4)
    base = _port_run(LLAMA, kw, [dataclasses.replace(r) for r in reqs])
    eng = ServeEngine(model, tc, compressed=True, kv="paged", attn="fused",
                      prefix_cache=True, device="cpu", **kw)
    faked, orig = [], eng._match

    def fake_first_match(req, now):
        if req.rid == 1 and not faked:
            faked.append(now)
            return 1, [], object()
        return orig(req, now)

    eng._match = fake_first_match
    out = eng.run(reqs)
    assert faked, "the fits-gate never consulted the fake match"
    assert not any(r.rejected for r in out.values())
    assert _tokens(out) == _tokens(base.results)


def test_prefix_eviction_unblocks_admission():
    """One slot, 6 usable blocks, two system prompts: cached-but-idle
    blocks must be LRU-evicted before the next admission can allocate."""
    _, _, tc, _ = _pair(LLAMA)
    reqs = shared_prefix_trace(tc, n_requests=4, prefix_len=5, suffix_len=3,
                               gen_lens=[4], seed=4, n_prefixes=2)
    kw = dict(n_slots=1, max_len=12, block_size=4, n_blocks=7,
              prefill_buckets=(4, 8))
    base = _port_run(LLAMA, kw, [dataclasses.replace(r) for r in reqs])
    eng = _port_run(LLAMA, dict(kw, prefix_cache=True), reqs)
    assert eng.index_evictions > 0
    assert _tokens(eng.results) == _tokens(base.results)


@pytest.mark.parametrize("mode", ["replay", "suspend"])
def test_preempt_mid_catchup_preserves_tokens(mode):
    """A victim still consuming its prompt (prompt 11 prefills 8, then 2
    forced decode ticks) is preempted in either mode, and every token
    equals the port's full-pool run's."""
    _, _, tc, model = _pair(LLAMA)
    args = dict(n_requests=3, prompt_len=11, gen_lens=[4], seed=8)
    kw = dict(n_slots=3, max_len=16, block_size=2, n_blocks=15,
              prefill_buckets=(4, 8, 16), compressed=True)
    full = _port_run(LLAMA, dict(kw, n_blocks=None),
                     synthetic_trace(tc, **args))
    eng = ServeEngine(model, tc, kv="paged", attn="fused", preempt=mode,
                      debug_invariants=True, device="cpu", **kw)
    pending, orig = [], eng._preempt

    def spy(slot):
        pending.append(len(eng._slots[slot].pending))
        orig(slot)

    eng._preempt = spy
    eng.run(synthetic_trace(tc, **args))
    assert any(n > 0 for n in pending), \
        f"no victim was mid-catch-up (pending at preemption: {pending})"
    assert _tokens(eng.results) == _tokens(full.results)
    st = eng.stats()
    assert st["swap_outs"] == st["swap_ins"] == (
        st["preemptions"] if mode == "suspend" else 0)


def test_cli_serves_prefix_cache_and_suspend_on_cpu(capsys):
    tlaunch.main(["--arch", LLAMA, "--smoke", "--device", "cpu",
                  "--scheduler", "continuous", "--kv", "paged",
                  "--attn", "fused", "--slots", "2", "--requests", "6", "--prompt-len", "8",
                  "--gen-mix", "2,4", "--block-size", "4", "--blocks", "6",
                  "--prefix-cache", "--prefix-mix", "2",
                  "--preempt", "suspend"])
    out = capsys.readouterr().out
    assert "continuous[compressed,paged,fused] on cpu: 18 tokens" in out
    assert "prefix cache: " in out and "(suspend: " in out
    hits = int(out.split("prefix cache: ")[1].split(" hits")[0])
    assert hits > 0
