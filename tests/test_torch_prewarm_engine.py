"""Port parity: a strict prewarmed engine (any mid-serve capture raises)
serves a mixed trace (bucket-down and pad-up prompts, speculation with
per-request opt-outs) with the tokens of the lazy port engine and of the
reference engine (smoke configs, f32, the reference's weights carried
over).  A file of its own so that a run spreading whole files over workers
runs it beside ``tests/test_torch_prewarm.py``.  Token streams and
counters are exact."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpecConfig as JSpec  # noqa: E402
from repro.serve import synthetic_request as jrequest  # noqa: E402
from _torch_engines import DEEPSEEK, LLAMA, one_thread, pair  # noqa: E402,F401
from repro_torch.serve import (ServeEngine, SpecConfig,  # noqa: E402
                               synthetic_request)


def _trace(cfg, plens, gens, make, seed=5, spec_off=()):
    rng = np.random.default_rng(seed)
    reqs = [make(cfg, rng, rid=i, prompt_len=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(plens, gens))]
    for r in reqs:
        if r.rid in spec_off:
            r.spec = False
    return reqs


def _tokens(results):
    return {rid: r.tokens.tolist() for rid, r in results.items()}


# prompts 3 (pads up to bucket 4) and 7, 5, 6 (bucket down to 4, then the
# rest replays as forced decode through the verify span; one prefill shape
# keeps the reference's compiles few); rid 1 opts out of speculation so the
# plain-decode row runs in the same ticks
MIXED = dict(plens=[3, 7, 5, 6], gens=[5, 4, 6, 3], spec_off=(1,))
SPEC_KEYS = ("decode_steps", "tokens", "prefill_calls", "preemptions",
             "spec_proposed", "spec_accepted", "spec_steps_saved",
             "draft_steps")


@pytest.mark.parametrize("arch,draft,compressed", [
    (LLAMA, "rerank", True), (DEEPSEEK, "skip", False)])
def test_strict_prewarmed_engine_matches_lazy_and_reference(arch, draft,
                                                            compressed):
    """The tentpole: a strict prewarmed engine (a mid-serve capture would
    raise) emits the lazy engine's tokens and the reference engine's, with
    every entry point covered before the first admission.  (deepseek
    serves its masked weights: the reference's compression pass over the
    expert stacks would take most of this file's time.)"""
    jc, params, tc, model = pair(arch)
    kw = dict(n_slots=3, max_len=24, kv="paged", block_size=4,
              compressed=compressed)
    jeng = JEngine(params, jc, attn="gather", spec=JSpec(k=2, draft=draft),
                   **kw)
    want = jeng.run(_trace(jc, make=jrequest, **MIXED))
    spec = SpecConfig(k=2, draft=draft)
    lazy = ServeEngine(model, tc, attn="fused", spec=spec, device="cpu",
                       **kw)
    r0 = lazy.run(_trace(tc, make=synthetic_request, **MIXED))
    eng = ServeEngine(model, tc, attn="fused", spec=spec, device="cpu",
                      prewarm=True, strict_prewarm=True, **kw)
    r1 = eng.run(_trace(tc, make=synthetic_request, **MIXED))
    assert _tokens(r1) == _tokens(r0) == _tokens(want)
    st, js = eng.stats(), jeng.stats()
    for key in SPEC_KEYS:
        assert st[key] == lazy.stats()[key] == js[key], key
    assert st["mid_serve_compiles"] == 0
    assert st["prewarmed_executables"] == st["executables_expected"] > 0
    assert st["warm_calls"] > 0 and not eng.graphs
    assert st["spec_proposed"] > 0        # the trace really speculates
    assert lazy.stats()["mid_serve_compiles"] > 0
