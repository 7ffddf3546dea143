"""Port parity for whisper-small (the audio family: requests of ``tokens``
+ ``enc_embeds``, cross K/V kept one row per slot) on every engine the
reference gives it: the paged engine (the fused kernel's plain route and
the gather read; self-attention K/V paged, cross K/V slot-indexed state),
the slotted engine, strict-prewarmed engines of both layouts, the
sequential oracle, suspend-to-host against the reference's and against
replay (the cross K/V rows swapped with the blocks), ``prefix_cache=True``
without a hit and ``spec=`` raising the reference's ``ValueError``, and the
CLI; greedy tokens bitwise and counters equal to the reference's (f32
smoke config, the reference's weights with nonzero qkv biases).  Prompts
of 1-3 tokens (below the smallest bucket) pad up, as the reference's: the
causal mask keeps the padding from the prompt's positions and the encoder
does not see the tokens; they are held to the reference's ``forward``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import forward as jforward  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpecConfig as JSpec  # noqa: E402
from repro.serve import serve_sequential as jsequential  # noqa: E402
from repro.serve import synthetic_request as jrequest  # noqa: E402
from repro.serve import synthetic_trace as jtrace  # noqa: E402
from _torch_engines import (assert_same_tokens, make,  # noqa: E402
                            one_thread, pair, port_engine,  # noqa: F401
                            ragged, ref_engine, single_thread)
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import (ServeEngine, SpecConfig,  # noqa: E402
                               serve_sequential, shared_prefix_trace,
                               synthetic_request, synthetic_trace)

WHISPER = "whisper-small"
# buckets 4, 8, 16, 20: 7, 9 and 12 bucket down and catch up; 2 pads up
RAGGED = dict(plens=[7, 9, 12, 2], gens=[5, 4, 6, 3], seed=3)
POOL = dict(n_slots=2, max_len=20, block_size=4, compressed=True)
# 3 requests of 4 + 6 in blocks of 2 over 10 usable blocks: preemption
TIGHT = dict(n_slots=3, max_len=12, block_size=2, n_blocks=11,
             compressed=True)
STAT_KEYS = ("tokens", "decode_steps", "ticks", "prefill_calls",
             "preemptions", "prefix_hits", "cow_copies", "swap_outs",
             "swap_ins", "index_blocks", "kv_bytes_resident",
             "kv_bytes_capacity", "kv_bytes_peak", "kv_state_bytes")


def _ragged(cfg):
    return ragged(cfg, make=make(cfg, jrequest, synthetic_request), **RAGGED)


def _stats(eng):
    st = eng.stats()
    return {k: st[k] for k in STAT_KEYS if k in st}


def test_paged_and_slotted_engines_match_reference():
    ref = ref_engine(WHISPER, _ragged, kv="paged", attn="gather", **POOL)
    for attn in ("fused", "gather"):
        eng = port_engine(WHISPER, _ragged, kv="paged", attn=attn,
                          debug_invariants=True, **POOL)
        assert_same_tokens(ref.results, eng.results, f"paged {attn}")
        assert _stats(eng) == _stats(ref)
    # self-attention K/V paged, the cross K/V one row per slot
    jc = pair(WHISPER)[0]
    assert eng.pool.state_bytes == 2 * jc.n_layers * 2 * jc.enc_seq * \
        jc.n_kv * jc.hd() * 4
    sref = ref_engine(WHISPER, _ragged, **POOL)
    slotted = port_engine(WHISPER, _ragged, **POOL)
    assert_same_tokens(sref.results, slotted.results, "slotted")
    st, js = _stats(slotted), _stats(sref)
    assert {k: st[k] for k in js} == js and js["decode_steps"] > 0
    assert_same_tokens(ref.results, slotted.results, "slotted = paged")
    assert slotted.stats()["kv_state_bytes"] == eng.pool.state_bytes


def test_strict_prewarmed_engines_match_reference():
    """Every prefill graph holds the encoder's frames [1, enc_seq, d] as a
    static input beside the bucket's tokens."""
    ref = ref_engine(WHISPER, _ragged, kv="paged", attn="gather", **POOL)
    paged = port_engine(WHISPER, _ragged, kv="paged", attn="fused",
                        prewarm=True, strict_prewarm=True, **POOL)
    _, _, tc, model = pair(WHISPER)
    slotted = ServeEngine(model, tc, device="cpu", strict_prewarm=True,
                          **POOL)
    slotted.prewarm(prompt_lens=RAGGED["plens"])
    slotted.run(_ragged(tc))
    for name, eng in (("paged", paged), ("slotted", slotted)):
        assert_same_tokens(ref.results, eng.results, f"strict {name}")
        st = eng.stats()
        assert st["mid_serve_compiles"] == 0
        assert st["prewarmed_executables"] == (
            st["executables_expected"] if name == "paged"
            else 1 + len(RAGGED["plens"]))
    shapes = {tuple(b.shape) for e in paged._prefill._exe.values()
              for b in e.static}
    assert (1, tc.enc_seq, tc.d_model) in shapes and (1, 16) in shapes


def test_sequential_oracle_matches_reference():
    jc, params, tc, model = pair(WHISPER)
    trace = dict(n_requests=4, prompt_len=8, gen_lens=[5, 3], seed=5)
    with single_thread():
        jres, jst = jsequential(params, jc, jtrace(jc, **trace), 2,
                                max_len=14)
    tres, tst = serve_sequential(model, tc, synthetic_trace(tc, **trace),
                                 2, max_len=14, device="cpu")
    assert_same_tokens(jres, tres, "sequential")
    assert tst["decode_steps"] == jst["decode_steps"]


def _three(cfg):
    rng = np.random.default_rng(6)
    build = make(cfg, jrequest, synthetic_request)
    return [build(cfg, rng, rid=i, prompt_len=4, max_new_tokens=6)
            for i in range(3)]


def test_suspend_matches_reference_and_replay():
    """A pool too small for the 3 requests at once: suspend swaps the
    slot's blocks and its cross K/V rows to the host and back."""
    keys = ("tokens", "decode_steps", "ticks", "prefill_calls",
            "preemptions", "swap_outs", "swap_ins", "kv_bytes_peak",
            "kv_state_bytes")
    ref = ref_engine(WHISPER, _three, kv="paged", preempt="suspend", **TIGHT)
    eng = port_engine(WHISPER, _three, kv="paged", attn="fused",
                      preempt="suspend", debug_invariants=True, **TIGHT)
    replay = port_engine(WHISPER, _three, kv="paged", attn="fused", **TIGHT)
    assert_same_tokens(ref.results, eng.results, "suspend")
    assert_same_tokens(replay.results, eng.results, "suspend = replay")
    st, js = eng.stats(), ref.stats()
    assert {k: st[k] for k in keys} == {k: js[k] for k in keys}
    assert st["preemptions"] > 0
    assert st["swap_outs"] == st["swap_ins"] == st["preemptions"]


def test_spec_raises_and_prefix_cache_takes_no_hit():
    jc, params, tc, model = pair(WHISPER)
    for draft in ("rerank", "skip"):
        with pytest.raises(ValueError, match="slot-indexed state"):
            JEngine(params, jc, kv="paged", spec=JSpec(k=3, draft=draft),
                    **POOL)
        with pytest.raises(ValueError, match="slot-indexed state"):
            ServeEngine(model, tc, kv="paged", spec=SpecConfig(
                k=3, draft=draft), device="cpu", **POOL)
    # the reference's prefix engine takes no hit either (its
    # ``_prefix_cacheable`` wants token-only prompts and an all-paged pool)
    ref = ref_engine(WHISPER, _ragged, kv="paged", attn="gather", **POOL)
    eng = port_engine(WHISPER, _ragged, kv="paged", attn="fused",
                      prefix_cache=True, debug_invariants=True, **POOL)
    assert_same_tokens(ref.results, eng.results, "prefix cache")
    st = eng.stats()
    assert st["prefix_hits"] == 0
    assert st["index_blocks"] == 0 and st["prefill_calls"] == 4
    with pytest.raises(ValueError, match="token-input family"):
        shared_prefix_trace(tc, n_requests=2, prefix_len=4, suffix_len=2,
                            gen_lens=[2])


def test_short_prompts_pad_up_to_the_reference_forward():
    """Prompts of 1-3 tokens on the paged engine pad up to bucket 4 with
    the encoder's frames whole: the tokens are the reference ``forward``'s
    greedy continuation over the same frames, and the port's slotted
    engine's."""
    jc, params, tc, _ = pair(WHISPER)
    gen = 3

    def short(cfg):
        rng = np.random.default_rng(7)
        build = make(cfg, jrequest, synthetic_request)
        return [build(cfg, rng, rid=i, prompt_len=p, max_new_tokens=gen)
                for i, p in enumerate((1, 2, 3))]
    paged = port_engine(WHISPER, short, kv="paged", attn="fused",
                        debug_invariants=True, **POOL)
    slotted = port_engine(WHISPER, short, **POOL)
    assert paged.stats()["prefill_calls"] == 3
    assert paged.prefill_lengths == {4}
    assert_same_tokens(slotted.results, paged.results, "slotted = paged")
    fwd = jax.jit(jforward, static_argnums=(1,))
    for req in short(tc):
        toks = list(req.inputs["tokens"])
        enc = jnp.asarray(req.inputs["enc_embeds"][None])
        for _ in range(gen):
            logits, _ = fwd(params, jc, {"tokens": jnp.asarray([toks]),
                                         "enc_embeds": enc})
            toks.append(int(jnp.argmax(logits[0, -1])))
        np.testing.assert_array_equal(paged.results[req.rid].tokens,
                                      toks[req.prompt_len:],
                                      err_msg=f"prompt {req.prompt_len}")


def test_cli_serves_on_cpu(capsys):
    args = ["--arch", WHISPER, "--smoke", "--device", "cpu", "--slots", "2",
            "--requests", "3", "--prompt-len", "6", "--gen-mix", "2,4"]
    tlaunch.main(args + ["--scheduler", "continuous", "--kv", "paged",
                         "--attn", "fused", "--block-size", "4",
                         "--preempt", "suspend", "--blocks", "6"])
    out = capsys.readouterr().out
    assert "continuous[compressed,paged,fused] on cpu: 8 tokens" in out
    tlaunch.main(args + ["--scheduler", "sequential"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "sequential[compressed]: 8 tokens in 4 decode steps"
    with pytest.raises(ValueError, match="slot-indexed state"):
        tlaunch.main(args + ["--scheduler", "continuous", "--kv", "paged",
                             "--spec"])
