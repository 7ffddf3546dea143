"""Port parity for falcon-mamba-7b (SSM) and zamba2-7b (hybrid) on the
engine's main paths: the paged engine (the fused kernel's plain route and
the gather read; the state slot-indexed, only the hybrid's shared-block
K/V paged), the slotted engine and strict-prewarmed engines of both
layouts, against the reference's paged engine, with greedy tokens and
counters exact (f32 smoke configs, the reference's jax.random weights
carried over).  The sequential oracle, suspend, ``spec=`` /
``prefix_cache=True``, short prompts and the CLI are in
``tests/test_torch_ssm_serve.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro.serve import synthetic_request as jrequest  # noqa: E402
from _torch_engines import (assert_same_tokens, make,  # noqa: E402
                            one_thread, pair, port_engine,  # noqa: F401
                            ragged, ref_engine)
from repro_torch.serve import ServeEngine, synthetic_request  # noqa: E402

FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-7b"
ARCHS = [FALCON, ZAMBA]
# every prompt buckets down (buckets 4, 8, 16, 20) and catches up
RAGGED = dict(plens=[7, 9, 12, 5], gens=[5, 4, 6, 3], seed=3)
POOL = dict(n_slots=2, max_len=20, block_size=4, compressed=True)
STAT_KEYS = ("tokens", "decode_steps", "ticks", "prefill_calls",
             "preemptions", "prefix_hits", "cow_copies", "swap_outs",
             "swap_ins", "index_blocks", "kv_bytes_resident",
             "kv_bytes_capacity", "kv_state_bytes")


def _ragged(cfg):
    return ragged(cfg, make=make(cfg, jrequest, synthetic_request), **RAGGED)


def _stats(eng):
    st = eng.stats()
    return {k: st[k] for k in STAT_KEYS if k in st}


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_and_slotted_engines_match_reference(arch):
    ref = ref_engine(arch, _ragged, kv="paged", attn="gather", **POOL)
    for attn in ("fused", "gather"):
        eng = port_engine(arch, _ragged, kv="paged", attn=attn,
                          debug_invariants=True, **POOL)
        assert_same_tokens(ref.results, eng.results, f"paged {attn}")
        assert _stats(eng) == _stats(ref)
    # the state is slot-indexed; only the hybrid's shared K/V is paged
    assert (eng.pool.bytes_per_block == 0) == (arch == FALCON)
    assert eng.pool.state_bytes > 0
    slotted = port_engine(arch, _ragged, **POOL)
    assert_same_tokens(ref.results, slotted.results, "slotted")
    st = slotted.stats()
    # slotted prefills each prompt at its length: no catch-up ticks
    assert st["prefill_calls"] == 4
    assert st["decode_steps"] < ref.stats()["decode_steps"]
    assert st["kv_state_bytes"] == eng.pool.state_bytes
    assert (st["kv_bytes_resident"] == 0) == (arch == FALCON)


@pytest.mark.parametrize("arch", ARCHS)
def test_strict_prewarmed_engines_match_reference(arch):
    ref = ref_engine(arch, _ragged, kv="paged", attn="gather", **POOL)
    paged = port_engine(arch, _ragged, kv="paged", attn="fused",
                        prewarm=True, strict_prewarm=True, **POOL)
    _, _, tc, model = pair(arch)
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
