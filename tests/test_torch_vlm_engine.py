"""Port parity for qwen2-vl-7b (the vlm family: requests of ``embeds``
[S, d], every cache leaf paged) on every engine the reference gives it:
the paged engine (the fused kernel's plain route and the gather read), the
slotted engine, a strict-prewarmed paged engine, the sequential oracle,
suspend-to-host against the reference's and against replay,
``prefix_cache=True`` without a hit, rerank and skip speculation against
the reference's speculative engine, and the CLI; greedy tokens bitwise and
counters equal to the reference's (f32 smoke config, the reference's
weights with nonzero qkv biases).  Embeddings prompts cannot replay
through the token decode step, so every one pads UP to its bucket, as the
reference's: a prompt of 37 (not a bucket) is also held to the
reference's ``forward``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import forward as jforward  # noqa: E402
from repro.models.common import embed_apply as jembed  # noqa: E402
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
                               serve_sequential, synthetic_request,
                               synthetic_trace)

QWEN = "qwen2-vl-7b"
# buckets 4, 8, 16, 20: every prompt pads up (to 8, 16, 16, 8)
RAGGED = dict(plens=[7, 9, 12, 5], gens=[5, 4, 6, 3], seed=3)
POOL = dict(n_slots=2, max_len=20, block_size=4, compressed=True)
TIGHT = dict(n_slots=3, max_len=12, block_size=2, n_blocks=11,
             compressed=True)
STAT_KEYS = ("tokens", "decode_steps", "ticks", "prefill_calls",
             "preemptions", "prefix_hits", "cow_copies", "swap_outs",
             "swap_ins", "index_blocks", "kv_bytes_resident",
             "kv_bytes_capacity", "kv_bytes_peak", "kv_state_bytes")
SPEC_KEYS = ("tokens", "decode_steps", "prefill_calls", "spec_proposed",
             "spec_accepted", "spec_steps_saved", "draft_steps",
             "draft_stream_bytes")


def _ragged(cfg):
    return ragged(cfg, make=make(cfg, jrequest, synthetic_request), **RAGGED)


def _stats(eng, keys=STAT_KEYS):
    st = eng.stats()
    return {k: st[k] for k in keys if k in st}


def test_paged_and_slotted_engines_match_reference():
    ref = ref_engine(QWEN, _ragged, kv="paged", attn="gather", **POOL)
    for attn in ("fused", "gather"):
        eng = port_engine(QWEN, _ragged, kv="paged", attn=attn,
                          debug_invariants=True, **POOL)
        assert_same_tokens(ref.results, eng.results, f"paged {attn}")
        assert _stats(eng) == _stats(ref)
    assert eng.prefill_lengths == {8, 16} and not eng.pool.state
    slotted = port_engine(QWEN, _ragged, **POOL)
    assert_same_tokens(ref.results, slotted.results, "slotted")
    assert slotted.stats()["prefill_calls"] == 4


def test_strict_prewarmed_engine_and_a_non_bucket_prompt():
    """A strict-prewarmed paged engine (each prefill graph's static input
    is the bucket's [1, bucket, d] embeddings) over prompts of 37 and 2
    (buckets 4, 8, 16, 32, 48): both pad up, and the tokens are the
    reference engine's and the reference ``forward``'s greedy continuation
    (the generated tokens embedded by the reference's table)."""
    jc, params, tc, _ = pair(QWEN)
    gen = 4
    kw = dict(n_slots=2, max_len=48, block_size=4, compressed=True)

    def prompts(cfg):
        rng = np.random.default_rng(8)
        build = make(cfg, jrequest, synthetic_request)
        return [build(cfg, rng, rid=i, prompt_len=p, max_new_tokens=gen)
                for i, p in enumerate((37, 2))]
    ref = ref_engine(QWEN, prompts, kv="paged", **kw)
    eng = port_engine(QWEN, prompts, kv="paged", attn="fused", prewarm=True,
                      strict_prewarm=True, debug_invariants=True, **kw)
    assert_same_tokens(ref.results, eng.results, "prompt 37")
    st = eng.stats()
    assert st["mid_serve_compiles"] == 0 and eng.prefill_lengths == {4, 48}
    assert st["prewarmed_executables"] == st["executables_expected"] == 1 + 5
    shapes = {tuple(b.shape) for e in eng._prefill._exe.values()
              for b in e.static}
    assert (1, 48, tc.d_model) in shapes
    fwd = jax.jit(jforward, static_argnums=(1,))
    for req in prompts(tc):
        x = jnp.asarray(req.inputs["embeds"])
        out = []
        for _ in range(gen):
            logits, _ = fwd(params, jc, {"embeds": x[None]})
            out.append(int(jnp.argmax(logits[0, -1])))
            x = jnp.concatenate([x, jembed(params["embed"],
                                           jnp.asarray([out[-1]]))])
        np.testing.assert_array_equal(eng.results[req.rid].tokens, out,
                                      err_msg=f"prompt {req.prompt_len}")


def test_sequential_oracle_matches_reference():
    jc, params, tc, model = pair(QWEN)
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


def test_suspend_and_prefix_cache_match_reference():
    """A pool too small for 3 requests at once: suspend against the
    reference's suspend engine and against replay.  With
    ``prefix_cache=True`` embeddings prompts take no hit (the index is
    keyed on tokens)."""
    keys = ("tokens", "decode_steps", "ticks", "prefill_calls",
            "preemptions", "swap_outs", "swap_ins", "kv_bytes_peak")
    ref = ref_engine(QWEN, _three, kv="paged", preempt="suspend", **TIGHT)
    eng = port_engine(QWEN, _three, kv="paged", attn="fused",
                      preempt="suspend", prefix_cache=True,
                      debug_invariants=True, **TIGHT)
    replay = port_engine(QWEN, _three, kv="paged", attn="fused", **TIGHT)
    assert_same_tokens(ref.results, eng.results, "suspend")
    assert_same_tokens(replay.results, eng.results, "suspend = replay")
    st, js = eng.stats(), ref.stats()
    assert {k: st[k] for k in keys} == {k: js[k] for k in keys}
    assert st["preemptions"] > 0 and st["prefix_hits"] == 0
    assert st["index_blocks"] == 0


@pytest.mark.parametrize("draft", ["rerank", "skip"])
def test_speculative_engine_matches_reference(draft):
    """Rerank and skip drafts (k 3): tokens and speculation counters as
    the reference's speculative engine, tokens as the port's plain
    engine (prompts padded up: no prompt replays through the span)."""
    jc, params, tc, model = pair(QWEN)
    kw = dict(n_slots=2, max_len=24, kv="paged", block_size=4,
              compressed=True)
    with single_thread():
        jeng = JEngine(params, jc, attn="gather",
                       spec=JSpec(k=3, draft=draft), **kw)
        jeng.run(_ragged(jc))
    eng = ServeEngine(model, tc, attn="fused", spec=SpecConfig(
        k=3, draft=draft), debug_invariants=True, device="cpu", **kw)
    eng.run(_ragged(tc))
    plain = ServeEngine(model, tc, attn="fused", device="cpu", **kw)
    plain.run(_ragged(tc))
    assert_same_tokens(jeng.results, eng.results, f"spec {draft}")
    assert_same_tokens(plain.results, eng.results, "spec = plain")
    assert _stats(eng, SPEC_KEYS) == _stats(jeng, SPEC_KEYS)
    assert eng.stats()["spec_proposed"] > 0
    assert eng.pool.free_blocks == eng.pool.usable_blocks


def test_cli_serves_on_cpu(capsys):
    args = ["--arch", QWEN, "--smoke", "--device", "cpu", "--slots", "2",
            "--requests", "3", "--prompt-len", "6", "--gen-mix", "2,4"]
    tlaunch.main(args + ["--scheduler", "continuous", "--kv", "paged",
                         "--attn", "fused", "--block-size", "4", "--spec"])
    out = capsys.readouterr().out
    assert "continuous[compressed,paged,fused] on cpu: 8 tokens" in out
    assert "speculative[rerank,k=3]" in out
    tlaunch.main(args + ["--scheduler", "sequential"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "sequential[compressed]: 8 tokens in 4 decode steps"
    with pytest.raises(ValueError, match="token-input family"):
        tlaunch.main(args + ["--scheduler", "continuous", "--kv", "paged",
                             "--prefix-cache"])
