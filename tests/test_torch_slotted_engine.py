"""Port parity for the slotted engine and the sequential oracle:
``ServeEngine(kv="slotted")`` (the default) against the reference's slotted
engine and against the port's paged engine on a ragged trace (after the
reference's ``tests/test_paged.py``), ``serve_sequential`` against the
reference's, continuous = sequential (after ``tests/test_serve.py``), the
slotted prewarm contract (``prewarm(prompt_lens=...)``, strict mode) and
the KV byte split of ``stats()``.  llama3.2-1b and deepseek-v2-lite-16b
smoke configs, f32, the reference's jax.random weights carried over;
greedy tokens and counters are exact."""

import pytest

torch = pytest.importorskip("torch")

from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import serve_sequential as jserve_sequential  # noqa: E402
from repro.serve import synthetic_request as jrequest  # noqa: E402
from repro.serve import synthetic_trace as jtrace  # noqa: E402
from _torch_engines import (DEEPSEEK, LLAMA, assert_same_tokens,  # noqa: E402,F401
                            one_thread, pair, ragged, single_thread)
from repro_torch.serve import (ServeEngine, serve_fixed_batch,  # noqa: E402
                               serve_sequential, synthetic_request,
                               synthetic_trace)

# the reference's ragged trace: prompt lengths straddle the paged engine's
# (4, 8, 16) buckets, so its exact-hit, bucket-down and pad-up paths run
RAGGED = dict(plens=[6, 11, 4], gens=[4, 2, 5], seed=9)
ENGINE_KEYS = ("tokens", "decode_steps", "ticks", "occupancy",
               "prefill_calls", "kv_bytes_resident", "kv_state_bytes",
               "weight_stream_bytes")


@pytest.fixture(scope="module", params=[LLAMA, DEEPSEEK])
def ragged_runs(request):
    """The reference's slotted engine and the port's on the ragged trace
    (2 slots, max_len 16): (arch, requests, reference engine, port
    engine)."""
    arch = request.param
    jc, params, tc, model = pair(arch)
    with single_thread():
        jeng = JEngine(params, jc, n_slots=2, max_len=16)
        jeng.run(ragged(jc, make=jrequest, **RAGGED))
        reqs = ragged(tc, make=synthetic_request, **RAGGED)
        eng = ServeEngine(model, tc, n_slots=2, max_len=16, device="cpu")
        eng.run(reqs)
    return arch, reqs, jeng, eng


def test_slotted_engine_matches_reference(ragged_runs):
    """Tokens and counters equal the reference slotted engine's, the KV
    bytes split included (every ported leaf has a sequence axis)."""
    _, _, jeng, eng = ragged_runs
    assert_same_tokens(jeng.results, eng.results, "reference vs port")
    st, js = eng.stats(), jeng.stats()
    assert {k: st[k] for k in ENGINE_KEYS} == {k: js[k] for k in ENGINE_KEYS}
    assert st["kv_bytes_resident"] == sum(
        t.numel() * t.element_size() for t in eng.caches.values())
    assert st["kv_state_bytes"] == 0
    assert eng.prefill_lengths == {4, 6, 11}          # one shape per length


def test_slotted_engine_equals_paged_engine():
    """The ragged trace through the paged pool (bucketed prefill, forced
    catch-up, pad-up) gives the slotted engine's tokens.  Held for the
    dense family, as the reference holds its row-independent families: in
    the MoE family idle rows compete for expert capacity, and the two
    layouts idle a row differently (stale row against token 0 at trash)."""
    _, _, tc, model = pair(LLAMA)
    reqs = ragged(tc, make=synthetic_request, **RAGGED)
    slotted = ServeEngine(model, tc, n_slots=2, max_len=16, device="cpu")
    paged = ServeEngine(model, tc, n_slots=2, max_len=16, kv="paged",
                        block_size=4, attn="fused", debug_invariants=True,
                        device="cpu")
    assert_same_tokens(slotted.run(reqs), paged.run(reqs),
                       "slotted vs paged")
    paged.check_invariants()
    assert paged.pool.used_blocks == 0


@pytest.fixture(scope="module", params=[LLAMA, DEEPSEEK])
def sequential_runs(request):
    """The reference's ``serve_sequential`` and the port's on one trace of
    simultaneous arrivals (2 requests x 8 prompt tokens, 2 slots).  MoE
    expert capacity couples batch rows, so deepseek keeps equal budgets
    (identical batch composition throughout, as the reference's
    ``test_continuous_equals_sequential``); llama mixes them."""
    arch = request.param
    jc, params, tc, model = pair(arch)
    gens = [5, 5] if arch == DEEPSEEK else [5, 3]
    args = dict(n_requests=2, prompt_len=8, gen_lens=gens, seed=1)
    with single_thread():
        jres, jst = jserve_sequential(params, jc, jtrace(jc, **args),
                                      n_slots=2)
        reqs = synthetic_trace(tc, **args)
        res, st = serve_sequential(model, tc, reqs, n_slots=2,
                                   device="cpu")
    return arch, reqs, (jres, jst), (res, st)


def test_serve_sequential_matches_reference(sequential_runs):
    _, reqs, (jres, jst), (res, st) = sequential_runs
    assert_same_tokens(jres, res, "reference vs port")
    assert st["decode_steps"] == jst["decode_steps"]
    for r in reqs:
        assert len(res[r.rid].tokens) == r.max_new_tokens


def test_continuous_equals_sequential(sequential_runs):
    """Simultaneous arrivals: the (slotted) engine's tokens match the
    fixed-batch oracle exactly."""
    arch, reqs, _, (seq, _) = sequential_runs
    _, _, tc, model = pair(arch)
    gen = max(r.max_new_tokens for r in reqs)
    eng = ServeEngine(model, tc, n_slots=2, max_len=8 + gen, device="cpu")
    assert_same_tokens(seq, eng.run(reqs), "sequential vs continuous")


def test_continuous_refill_matches_sequential_outputs():
    """More requests than slots: refill changes when each request decodes,
    never what it emits, in fewer decode steps (the reference's throughput
    claim, deterministically)."""
    _, _, tc, model = pair(LLAMA)
    reqs = synthetic_trace(tc, n_requests=5, prompt_len=8,
                           gen_lens=[6, 2, 4, 3, 5], seed=2)
    seq, sst = serve_sequential(model, tc, reqs, n_slots=2, device="cpu")
    eng = ServeEngine(model, tc, n_slots=2, max_len=8 + 6, device="cpu")
    assert_same_tokens(seq, eng.run(reqs), "sequential vs continuous")
    assert eng.decode_steps < sst["decode_steps"] == 5 + 3 + 4
    assert eng.scheduler.occupancy() > 0.8


def test_fixed_batch_checks_and_trims():
    """One batch: prompts of one length only; each output trimmed to its
    own budget; ``max_new_tokens=1`` runs no decode step."""
    _, _, tc, model = pair(LLAMA)
    reqs = synthetic_trace(tc, n_requests=3, prompt_len=5,
                           gen_lens=[1, 3, 2], seed=3)
    res, st = serve_fixed_batch(model, tc, reqs, device="cpu")
    assert [len(res[r.rid].tokens) for r in reqs] == [1, 3, 2]
    assert st["decode_steps"] == 2
    one, st1 = serve_fixed_batch(model, tc, reqs[:1], device="cpu")
    assert st1["decode_steps"] == 0
    assert one[0].tokens.tolist() == res[0].tokens.tolist()
    mixed = ragged(tc, [4, 6], [2, 2], 1, synthetic_request)
    with pytest.raises(ValueError, match="equal prompt lengths"):
        serve_fixed_batch(model, tc, mixed, device="cpu")


def test_sequential_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, tc, model = pair(LLAMA)
    reqs = synthetic_trace(tc, n_requests=1, prompt_len=4, gen_lens=[2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_sequential(model, tc, reqs, n_slots=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, tc, n_slots=1, max_len=8)


# ------------------------------------------------------------------ prewarm

def test_slotted_prewarm_takes_the_traces_prompt_lengths():
    """Slotted prefill is per prompt length: ``prewarm(prompt_lens=)``
    covers a trace (strict: no mid-serve capture), a length it did not
    name raises under strict mode, and the shape set equals the
    reference's."""
    jc, params, tc, model = pair(LLAMA)
    reqs = ragged(tc, make=synthetic_request, **RAGGED)
    eng = ServeEngine(model, tc, n_slots=2, max_len=16, device="cpu",
                      strict_prewarm=True)
    eng.prewarm(prompt_lens=[r.prompt_len for r in reqs])
    assert eng.executable_shapes() == JEngine(
        params, jc, n_slots=2, max_len=16).executable_shapes()
    st = eng.stats()
    assert st["prewarmed_executables"] == 1 + 3       # decode + 3 lengths
    eng.run(reqs)
    assert eng.stats()["mid_serve_compiles"] == 0
    with pytest.raises(RuntimeError, match="mid-serve compile"):
        eng.run(ragged(tc, [7], [2], 3, synthetic_request))


def test_prefill_only_trace_serves_without_decode_ticks():
    """Every request satisfied by prefill alone: no decode step, and
    stats() divides by nothing."""
    _, _, tc, model = pair(LLAMA)
    reqs = synthetic_trace(tc, n_requests=3, prompt_len=4, gen_lens=[1],
                           seed=3)
    eng = ServeEngine(model, tc, n_slots=2, max_len=8, device="cpu")
    res = eng.run(reqs)
    assert sorted(res) == [0, 1, 2]
    assert all(len(r.tokens) == 1 for r in res.values())
    st = eng.stats()
    assert st["decode_steps"] == 0 and st["occupancy"] == 0.0
