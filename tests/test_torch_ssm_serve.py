"""Port parity for falcon-mamba-7b (SSM) and zamba2-7b (hybrid) on the
serve features around the engine: the sequential oracle, suspend-to-host
preemption (the state rows swapped with the blocks) against the
reference's and against replay, ``spec=`` raising the reference's
``ValueError``, ``prefix_cache=True`` running without a hit as in the
reference, and the CLI (f32 smoke configs, the reference's jax.random
weights carried over; greedy tokens and counters exact).

Prompts shorter than the smallest prefill bucket (4): the reference pads
them up, which runs the padding through the recurrence and the conv and
seeds a wrong state.  The port plans no prefill there and replays the
whole prompt through forced decode from the zero state; its paged engine
is held to the reference's ``forward`` (greedy, token by token) and to
its own slotted engine."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import forward as jforward  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpecConfig as JSpec  # noqa: E402
from repro.serve import serve_sequential as jsequential  # noqa: E402
from repro.serve import shared_prefix_trace as jprefix_trace  # noqa: E402
from repro.serve import synthetic_request as jrequest  # noqa: E402
from repro.serve import synthetic_trace as jtrace  # noqa: E402
from _torch_engines import (assert_same_tokens, make,  # noqa: E402
                            one_thread, pair, port_engine,  # noqa: F401
                            ref_engine, single_thread)
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import (ServeEngine, SpecConfig,  # noqa: E402
                               serve_sequential, shared_prefix_trace,
                               synthetic_request, synthetic_trace)

FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-7b"
ARCHS = [FALCON, ZAMBA]
POOL = dict(n_slots=2, max_len=20, block_size=4, compressed=True)
# 3 requests of 4 + 6 in blocks of 2 over 10 usable blocks: preemption
TIGHT = dict(n_slots=3, max_len=12, block_size=2, n_blocks=11,
             compressed=True)
SUSPEND_KEYS = ("tokens", "decode_steps", "ticks", "prefill_calls",
                "preemptions", "swap_outs", "swap_ins", "kv_bytes_peak",
                "kv_state_bytes")


@pytest.mark.parametrize("arch", ARCHS)
def test_sequential_oracle_matches_reference(arch):
    jc, params, tc, model = pair(arch)
    trace = dict(n_requests=4, prompt_len=8, gen_lens=[5, 3], seed=5)
    with single_thread():
        jres, jst = jsequential(params, jc, jtrace(jc, **trace), 2,
                                max_len=14)
    tres, tst = serve_sequential(model, tc, synthetic_trace(tc, **trace),
                                 2, max_len=14, device="cpu")
    assert_same_tokens(jres, tres, "sequential")
    assert tst["decode_steps"] == jst["decode_steps"]


def _four(cfg):
    rng = np.random.default_rng(6)
    build = make(cfg, jrequest, synthetic_request)
    return [build(cfg, rng, rid=i, prompt_len=4, max_new_tokens=6)
            for i in range(3)]


@pytest.mark.parametrize("arch", ARCHS)
def test_suspend_matches_reference_and_replay(arch):
    """A pool too small for the 3 requests at once: suspend-to-host swaps
    the slot's blocks and its state rows out and back (tokens and counters
    as the reference's suspend engine, tokens as replay's)."""
    ref = ref_engine(arch, _four, kv="paged", preempt="suspend", **TIGHT)
    eng = port_engine(arch, _four, kv="paged", attn="fused",
                      preempt="suspend", debug_invariants=True, **TIGHT)
    replay = port_engine(arch, _four, kv="paged", attn="fused", **TIGHT)
    assert_same_tokens(ref.results, eng.results, "suspend")
    assert_same_tokens(replay.results, eng.results, "suspend = replay")
    st, js = eng.stats(), ref.stats()
    assert {k: st[k] for k in SUSPEND_KEYS} == \
        {k: js[k] for k in SUSPEND_KEYS}
    assert st["preemptions"] > 0
    assert st["swap_outs"] == st["swap_ins"] == st["preemptions"]
    assert st["swap_bytes_resident"] == 0


def _prefix(cfg):
    build = make(cfg, jprefix_trace, shared_prefix_trace)
    return build(cfg, n_requests=4, prefix_len=6, suffix_len=2,
                 gen_lens=[3], seed=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_raises_and_prefix_cache_takes_no_hit(arch):
    jc, params, tc, model = pair(arch)
    for draft in ("rerank", "skip"):
        with pytest.raises(ValueError, match="slot-indexed state"):
            JEngine(params, jc, kv="paged", spec=JSpec(k=3, draft=draft),
                    **POOL)
        with pytest.raises(ValueError, match="slot-indexed state"):
            ServeEngine(model, tc, kv="paged", spec=SpecConfig(
                k=3, draft=draft), device="cpu", **POOL)
    ref = ref_engine(arch, _prefix, kv="paged", prefix_cache=True, **POOL)
    eng = port_engine(arch, _prefix, kv="paged", attn="fused",
                      prefix_cache=True, debug_invariants=True, **POOL)
    assert_same_tokens(ref.results, eng.results, "prefix cache")
    st = eng.stats()
    assert st["prefix_hits"] == ref.stats()["prefix_hits"] == 0
    assert st["index_blocks"] == 0 and st["prefill_calls"] == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompts_start_from_zero_state(arch):
    """Prompts of 1-3 tokens (below the smallest bucket) on the paged
    engine: no prefill, the prompt replays from the zero state, and the
    tokens are the reference ``forward``'s greedy continuation and the
    port's slotted engine's (which prefills each prompt at its length)."""
    jc, params, tc, _ = pair(arch)
    gen = 3

    def short(cfg):
        rng = np.random.default_rng(7)
        return [synthetic_request(cfg, rng, rid=i, prompt_len=p,
                                  max_new_tokens=gen)
                for i, p in enumerate((1, 2, 3))]
    paged = port_engine(arch, short, kv="paged", attn="fused",
                        debug_invariants=True, **POOL)
    slotted = port_engine(arch, short, **POOL)
    assert paged.stats()["prefill_calls"] == 0
    assert_same_tokens(slotted.results, paged.results, "slotted = paged")
    fwd = jax.jit(jforward, static_argnums=(1,))
    for req in short(tc):
        toks = list(req.inputs["tokens"])
        for _ in range(gen):
            logits, _ = fwd(params, jc, {"tokens": jnp.asarray([toks])})
            toks.append(int(jnp.argmax(logits[0, -1])))
        np.testing.assert_array_equal(paged.results[req.rid].tokens,
                                      toks[req.prompt_len:],
                                      err_msg=f"prompt {req.prompt_len}")


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_on_cpu(arch, capsys):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--slots", "2",
            "--requests", "3", "--prompt-len", "6", "--gen-mix", "2,4"]
    tlaunch.main(args + ["--scheduler", "continuous", "--kv", "paged",
                         "--attn", "fused", "--block-size", "4",
                         "--preempt", "suspend", "--prefix-cache"])
    out = capsys.readouterr().out
    assert "continuous[compressed,paged,fused] on cpu: 8 tokens" in out
    assert "prefix cache: 0 hits / 3 prefills" in out
    tlaunch.main(args + ["--scheduler", "sequential"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "sequential[compressed]: 8 tokens in 4 decode steps"
    with pytest.raises(ValueError, match="slot-indexed state"):
        tlaunch.main(args + ["--scheduler", "continuous", "--kv", "paged",
                             "--spec"])
