"""Port parity: the speculative engine against the reference speculative
engine (llama3.2-1b rerank and skip drafts, deepseek-v2-lite-16b skip
draft; smoke configs, f32, the reference's weights carried over).  A file
of its own so that a run spreading whole files over workers runs it beside
``tests/test_torch_spec.py``.  Token streams and counters are exact."""

import pytest

torch = pytest.importorskip("torch")

from _torch_engines import (DEEPSEEK, LLAMA, SPEC_KEYS,  # noqa: E402,F401
                            assert_same_tokens, one_thread, spec_engines)


@pytest.mark.parametrize("arch,draft", [(LLAMA, "rerank"), (LLAMA, "skip"),
                                        (DEEPSEEK, "skip")])
def test_engine_spec_matches_reference(arch, draft):
    """Token streams and every spec counter equal the reference spec
    engine's, and the tokens equal the port's non-spec engine's in fewer
    target passes.  At 2 slots x 4 span tokens the MoE verify batch stays
    under the expert-capacity floor, so no route drops."""
    (jres, js), (tres, ts), (pres, ps) = spec_engines(
        arch, draft, plens=[6, 11, 4, 7], gens=[8, 6, 9, 7], seed=7)
    assert_same_tokens(jres, tres, "reference vs port")
    assert_same_tokens(pres, tres, "port non-spec vs spec")
    for key in SPEC_KEYS:
        assert ts[key] == js[key], key
    assert ts["spec_steps_saved"] > 0
    assert ts["decode_steps"] < ps["decode_steps"]
