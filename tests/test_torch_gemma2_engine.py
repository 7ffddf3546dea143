"""Port parity for gemma2-9b on every serve path: the paged engine (fused
kernel's plain route and gather read) against the reference's paged engine,
the prefix cache with copy-on-write and suspend-to-host preemption, rerank
speculation, and the slotted engine and the sequential oracle, which are
held to the reference's paged engine (the reference's slotted layout seeds
a local ring wrong once a prompt passes the window; see
``tests/test_torch_gemma2.py``).  Smoke config (f32, window 32, block size
4), the reference's jax.random weights carried over; every trace has
prompts past the window, so the local layers' window bites on each path.
Greedy tokens and counters are exact."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpecConfig as JSpec  # noqa: E402
from repro.serve import shared_prefix_trace as jprefix_trace  # noqa: E402
from repro.serve import synthetic_request as jrequest  # noqa: E402
from repro.serve import synthetic_trace as jtrace  # noqa: E402
from _torch_engines import (assert_same_tokens, one_thread,  # noqa: E402,F401
                            pair, ragged, single_thread)
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import (ServeEngine, SpecConfig,  # noqa: E402
                               serve_sequential, shared_prefix_trace,
                               synthetic_request, synthetic_trace)

GEMMA = "gemma2-9b"
# prompts 40 and 35 pass the window (32), 9 and 12 do not; 40 buckets down
# to 32 and catches up through decode, 35 too, 9 and 12 pad or bucket
RAGGED = dict(plens=[40, 9, 35, 12], gens=[6, 5, 7, 4], seed=3)
PAGED = dict(n_slots=2, max_len=48, kv="paged", block_size=4,
             compressed=True)
STAT_KEYS = ("tokens", "decode_steps", "ticks", "prefill_calls",
             "preemptions", "prefix_hits", "prefix_hit_tokens",
             "cow_copies", "swap_outs", "swap_ins", "index_evictions",
             "index_blocks", "kv_bytes_resident", "kv_bytes_capacity")
SPEC_KEYS = ("spec_proposed", "spec_accepted", "spec_steps_saved",
             "draft_steps")
# shared-prefix trace: one of two 34-token system prompts + 4, so every
# prompt (38) passes the window and a hit ends mid-block (COW)
PREFIX_TRACE = dict(n_requests=8, prefix_len=34, suffix_len=4,
                    gen_lens=[3, 5], seed=1, n_prefixes=2)
PREFIX_POOL = dict(n_slots=3, max_len=48, block_size=4, n_blocks=34,
                   prefill_buckets=(4, 32), compressed=True)
_REF = {}


def _ref(name, make):
    if name not in _REF:
        with single_thread():
            _REF[name] = make()
    return _REF[name]


def _ref_ragged(spec=None):
    jc, params, _, _ = pair(GEMMA)

    def run():
        eng = JEngine(params, jc, attn="gather", spec=spec, **PAGED)
        eng.run(ragged(jc, make=jrequest, **RAGGED))
        return eng
    return _ref(("ragged", spec is not None), run)


def _port(trace, **kw):
    _, _, tc, model = pair(GEMMA)
    eng = ServeEngine(model, tc, device="cpu", **kw)
    eng.run(trace(tc))
    if eng.pool is not None:
        eng.check_invariants()
    return eng


def _ragged(tc):
    return ragged(tc, make=synthetic_request, **RAGGED)


@pytest.mark.parametrize("attn", ["fused", "gather"])
def test_paged_engine_matches_reference(attn):
    ref = _ref_ragged()
    eng = _port(_ragged, attn=attn, debug_invariants=True, **PAGED)
    assert_same_tokens(ref.results, eng.results, f"paged {attn}")
    st, js = eng.stats(), ref.stats()
    keys = [k for k in STAT_KEYS if k in js]
    assert {k: st[k] for k in keys} == {k: js[k] for k in keys}
    # one [L, ...] pool: local layers go through the table like global ones
    assert eng.pool.caches["k"].shape[0] == pair(GEMMA)[2].n_layers


def test_rerank_speculation_matches_reference_and_plain():
    spec = _ref_ragged(JSpec(k=3, draft="rerank"))
    eng = _port(_ragged, attn="fused", spec=SpecConfig(k=3, draft="rerank"),
                debug_invariants=True, **PAGED)
    assert_same_tokens(spec.results, eng.results, "spec")
    assert_same_tokens(_ref_ragged().results, eng.results, "spec = plain")
    st, js = eng.stats(), spec.stats()
    assert {k: st[k] for k in SPEC_KEYS} == {k: js[k] for k in SPEC_KEYS}
    assert st["spec_proposed"] > 0


@pytest.mark.parametrize("flags", [dict(prefix_cache=True),
                                   dict(prefix_cache=True,
                                        preempt="suspend", n_slots=4,
                                        n_blocks=25)])
def test_prefix_and_suspend_match_reference(flags):
    """The prefix cache (hits end mid-block: COW), and with a tight pool
    suspend-to-host too: tokens and counters equal the reference engine's,
    and the tokens equal the port's non-sharing run's."""
    jc, params, _, _ = pair(GEMMA)
    kw = dict(PREFIX_POOL, **flags)
    key = tuple(sorted(flags.items()))

    def run():
        eng = JEngine(params, jc, kv="paged", attn="gather", **kw)
        eng.run(jprefix_trace(jc, **PREFIX_TRACE))
        return eng
    ref = _ref(key, run)
    trace = lambda tc: shared_prefix_trace(tc, **PREFIX_TRACE)  # noqa: E731
    eng = _port(trace, kv="paged", attn="fused", debug_invariants=True, **kw)
    plain = _port(trace, kv="paged", attn="fused",
                  **dict(PREFIX_POOL, n_blocks=None))
    assert_same_tokens(ref.results, eng.results, "prefix")
    assert_same_tokens(plain.results, eng.results, "prefix = non-sharing")
    st, js = eng.stats(), ref.stats()
    assert {k: st[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    assert st["prefix_hits"] > 0 and st["cow_copies"] > 0
    if flags.get("preempt") == "suspend":
        assert st["preemptions"] > 0
        assert st["swap_outs"] == st["swap_ins"] == st["preemptions"]


def test_slotted_and_sequential_equal_paged_past_the_window():
    """Prompts of 40 (> window 32) in two fixed batches: the slotted
    engine, the sequential oracle, the port's paged engine and the
    reference's paged engine emit the same tokens; the slotted engine's
    local rings hold 32 positions."""
    jc, params, tc, model = pair(GEMMA)
    trace = dict(n_requests=4, prompt_len=40, gen_lens=[6, 3], seed=4)
    kw = dict(n_slots=2, max_len=48, compressed=True)

    def run():
        eng = JEngine(params, jc, kv="paged", attn="gather", block_size=4,
                      **kw)
        eng.run(jtrace(jc, **trace))
        return eng
    ref = _ref("trace40", run)
    slotted = _port(lambda c: synthetic_trace(c, **trace), prewarm=True,
                    **kw)
    slotted_strict = ServeEngine(model, tc, device="cpu", strict_prewarm=True,
                                 **kw)
    slotted_strict.prewarm(prompt_lens=[40])
    slotted_strict.run(synthetic_trace(tc, **trace))
    paged = _port(lambda c: synthetic_trace(c, **trace), kv="paged",
                  attn="fused", block_size=4, **kw)
    ccfg = tc.replace(sparsity=dataclasses.replace(tc.sparsity,
                                                   mode="compressed"))
    seq, st = serve_sequential(slotted.model, ccfg,
                               synthetic_trace(tc, **trace), 2, 48,
                               device="cpu")
    for name, res in (("slotted", slotted.results),
                      ("slotted strict", slotted_strict.results),
                      ("paged", paged.results), ("sequential", seq)):
        assert_same_tokens(ref.results, res, name)
    assert slotted.caches["local"]["k"].shape[2] == 32
    assert slotted.caches["global"]["k"].shape[2] == 48
    sst = slotted.stats()
    assert sst["kv_bytes_resident"] == sum(
        t.numel() * t.element_size() for kind in slotted.caches.values()
        for t in kind.values())
    assert slotted_strict.stats()["mid_serve_compiles"] == 0


def test_cli_serves_gemma2_on_cpu(capsys):
    args = ["--arch", GEMMA, "--smoke", "--device", "cpu", "--slots", "2",
            "--requests", "3", "--prompt-len", "36", "--gen-mix", "2,4"]
    tlaunch.main(args + ["--scheduler", "continuous", "--kv", "paged",
                         "--attn", "fused", "--block-size", "4"])
    out = capsys.readouterr().out
    assert "continuous[compressed,paged,fused] on cpu: 8 tokens" in out
    tlaunch.main(args + ["--scheduler", "sequential"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("sequential[compressed]: ")
