"""Port parity: the speculative engine against the reference's with
per-request opt-outs and a pool small enough to demote speculating slots
and preempt (llama3.2-1b skip draft; smoke config, f32, the reference's
weights carried over).  A file of its own so that a run spreading whole
files over workers runs it beside ``tests/test_torch_spec.py``.  Token
streams and counters are exact."""

import pytest

torch = pytest.importorskip("torch")

from _torch_engines import (LLAMA, SPEC_KEYS, assert_same_tokens,  # noqa: E402,F401
                            one_thread, spec_engines)
from repro_torch.serve import ServeEngine  # noqa: E402


def test_engine_spec_override_and_demotion_match_reference(monkeypatch):
    """Half the requests opt out (``Request.spec=False``) and ride the
    plain forward in the same ticks; the pool (7 usable blocks for 2 slots
    of up to 6) is small enough that speculating slots get demoted to a
    1-wide span, and a preemption follows.  Still equal to the reference
    and to the non-spec engine."""
    demoted = []
    orig = ServeEngine._prepare_slots

    def watch(self, spec_set=None):
        before = set(spec_set or ())
        orig(self, spec_set)
        demoted.extend(before - set(spec_set or ()))
    monkeypatch.setattr(ServeEngine, "_prepare_slots", watch)
    (jres, js), (tres, ts), (pres, _) = spec_engines(
        LLAMA, "skip", plens=[9, 13, 6, 12, 8], gens=[11, 9, 10, 8, 12],
        seed=5, spec_on=[None, False, True, False, None], n_blocks=8)
    assert_same_tokens(jres, tres, "reference vs port")
    assert_same_tokens(pres, tres, "port non-spec vs spec")
    for key in SPEC_KEYS:
        assert ts[key] == js[key], key
    assert demoted, "trace no longer forces a demotion"
    assert ts["preemptions"] > 0 and ts["spec_proposed"] > 0
