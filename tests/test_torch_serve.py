"""Port parity: the continuous-batching engine over the paged pool
(repro_torch.serve) against the reference ServeEngine(kv="paged",
attn="fused", compressed=True), with the reference's weights carried over.
Token streams must be equal, and so must decode_steps / prefill_calls /
preemptions, on a trace whose pool is small enough to force replay
preemption.  A flipped token is reported with the top-2 logit margin of the
step where it flipped; the test never loosens to "most tokens match"."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import synthetic_trace as jtrace  # noqa: E402
from repro.serve.paged import default_buckets as jbuckets  # noqa: E402
from _torch_engines import one_thread  # noqa: E402,F401
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import from_reference_params  # noqa: E402
from repro_torch.dist.api import ServeMesh  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import decode_step, prefill  # noqa: E402
from repro_torch.serve import (BlockPool, ServeEngine, SpecConfig,  # noqa: E402
                               TRASH_BLOCK, default_buckets, synthetic_trace)

_MODEL = {}


def _model():
    if not _MODEL:
        jc, tc = jget("llama3.2-1b", smoke=True), tget("llama3.2-1b", smoke=True)
        params, _ = jinit(jax.random.PRNGKey(0), jc)
        model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                      device="cpu")
        _MODEL.update(jc=jc, params=params, tc=tc, model=model)
    return _MODEL["jc"], _MODEL["params"], _MODEL["tc"], _MODEL["model"]


class _MarginProbe:
    """Wraps the port's prefill/decode to log the top-2 logit margin of every
    emitted argmax, so a token mismatch can be reported with its margin."""

    def __init__(self):
        self.margins = []

    def _log(self, logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        self.margins.append((top[:, 0] - top[:, 1]).min().item())

    def prefill(self, *a, **k):
        out = prefill(*a, **k)
        self._log(out[0])
        return out

    def decode_step(self, *a, **k):
        out = decode_step(*a, **k)
        self._log(out[0])
        return out


@pytest.mark.parametrize("attn", ["fused", "gather"])
def test_engine_token_streams_equal_reference_under_preemption(monkeypatch,
                                                               attn):
    jc, params, tc, model = _model()
    kw = dict(n_slots=3, max_len=24, compressed=True, kv="paged",
              block_size=4, n_blocks=8, attn=attn)
    # prompt 7 buckets down to 4 (the other 3 tokens replay as forced
    # decode); 3 slots x up to 4 blocks oversubscribe the 7 usable blocks
    args = dict(n_requests=6, prompt_len=7, gen_lens=[5, 9, 3], seed=3)
    jreqs, treqs = jtrace(jc, **args), synthetic_trace(tc, **args)
    for a, b in zip(jreqs, treqs):
        np.testing.assert_array_equal(a.inputs["tokens"], b.inputs["tokens"])
    jeng = JEngine(params, jc, **kw)
    jres = jeng.run(jreqs)
    probe = _MarginProbe()
    from repro_torch.serve import engine as engine_mod
    monkeypatch.setattr(engine_mod, "prefill", probe.prefill)
    monkeypatch.setattr(engine_mod, "decode_step", probe.decode_step)
    teng = ServeEngine(model, tc, debug_invariants=True, device="cpu", **kw)
    tres = teng.run(treqs)
    assert jeng.preemptions > 0, "trace no longer forces a preemption"
    for r in jreqs:
        want, got = jres[r.rid].tokens, tres[r.rid].tokens
        if not np.array_equal(want, got):
            i = int(np.argmax(want[:len(got)] != got[:len(want)]))
            pytest.fail(f"rid {r.rid}: token {i} flipped ({want[i]} vs "
                        f"{got[i]}); smallest top-2 logit margin seen by the "
                        f"port: {min(probe.margins):.3e}")
    js, ts = jeng.stats(), teng.stats()
    for key in ("decode_steps", "prefill_calls", "preemptions", "tokens",
                "ticks", "occupancy", "weight_stream_ratio",
                "weight_stream_bytes"):
        assert ts[key] == js[key], key
    teng.check_invariants(active_pos={})
    assert teng.pool.free_blocks == teng.pool.usable_blocks


def test_engine_pads_up_short_prompts_and_serves_single_tokens():
    """A prompt shorter than the smallest bucket pads up and reads its
    logits at prompt_len - 1; max_new_tokens=1 retires at admission."""
    jc, params, tc, model = _model()
    rng = np.random.default_rng(4)
    from repro.serve import Request as JReq
    from repro_torch.serve import Request as TReq
    prompts = [rng.integers(0, jc.vocab, (n,)).astype(np.int32)
               for n in (1, 3, 5)]
    gens = [3, 1, 4]
    kw = dict(n_slots=2, max_len=12, compressed=True, kv="paged",
              block_size=4, attn="fused")
    jres = JEngine(params, jc, **kw).run(
        [JReq(i, {"tokens": p}, g) for i, (p, g) in enumerate(zip(prompts, gens))])
    teng = ServeEngine(model, tc, device="cpu", **kw)
    tres = teng.run(
        [TReq(i, {"tokens": p}, g) for i, (p, g) in enumerate(zip(prompts, gens))])
    for i in range(3):
        np.testing.assert_array_equal(tres[i].tokens, jres[i].tokens)
    assert teng.prefill_lengths == {4}


def test_default_buckets_match_reference():
    for n in (1, 4, 5, 24, 160, 4096):
        assert default_buckets(n) == jbuckets(n)


def _pool(n_slots=2, max_len=8, block_size=4, n_blocks=None):
    return BlockPool(tget("llama3.2-1b", smoke=True), n_slots, max_len,
                     block_size, n_blocks, device="cpu")


def test_block_pool_shapes_and_reuse_order():
    p = _pool(n_slots=2, max_len=8, block_size=4)
    assert p.caches["k"].shape == (4, 5, 4, 4, 64)
    assert p.alloc(0, 2) and p.alloc(1, 1)
    assert list(p.table[0]) == [1, 2] and list(p.table[1]) == [3, 0]
    p.free(0)
    assert list(p.table[0]) == [TRASH_BLOCK, TRASH_BLOCK]
    assert p.alloc(1, 1) and list(p.table[1]) == [3, 1]   # lowest id first
    assert not p.alloc(0, 3)
    p.check_invariants(active_pos={1: 7})


def test_check_invariants_detects_read_after_free():
    p = _pool()
    assert p.alloc(0, 2) and p.alloc(1, 1)
    freed = p._owned[1][0]
    p.free(1)
    p.table[0, 1] = freed
    p._owned[0][1] = freed
    with pytest.raises(AssertionError, match="freed block"):
        p.check_invariants()


def test_check_invariants_detects_unbacked_decode_position():
    p = _pool(n_slots=1, max_len=16)
    assert p.alloc(0, 1)
    p.check_invariants(active_pos={0: 3})
    with pytest.raises(AssertionError, match="walk into trash"):
        p.check_invariants(active_pos={0: 4})


def test_idle_rows_write_only_the_trash_block():
    """Idle slots (position 0, token 0, all-trash table row) all write
    block 0 in one decode step; no live block changes."""
    _, _, tc, model = _model()
    p = _pool(n_slots=3, max_len=8)
    assert p.alloc(0, 1)
    before = {k: v.clone() for k, v in p.caches.items()}
    decode_step(model, tc, p.caches, torch.tensor([5, 0, 0]),
                torch.tensor([0, 0, 0], dtype=torch.int32), p.device_table(),
                attn_impl="fused")
    for name, leaf in p.caches.items():
        changed = (leaf != before[name]).flatten(2).any(-1).any(0)
        assert changed.nonzero().flatten().tolist() == [0, 1]  # trash + own
    p.check_invariants(active_pos={0: 0})


@pytest.mark.parametrize("kw,msg", [
    (dict(kv="paged", spec=SpecConfig(draft="skip"),
          mesh=ServeMesh(size=2, rank=0, device=torch.device("cpu"),
                         backend="gloo")), "mesh"),
    (dict(mesh=object()), "mesh"),
])
def test_unported_engine_features_raise(kw, msg):
    """``mesh=`` is served since tensor-parallel serving was ported; what
    it still refuses, as the reference does: ``spec=`` over a mesh, and a
    mesh without a 'model' axis."""
    _, _, tc, model = _model()
    with pytest.raises(ValueError, match=msg):
        ServeEngine(model, tc, n_slots=1, max_len=8, device="cpu", **kw)


def test_cli_serves_on_cpu(capsys):
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--slots",
            "2", "--requests", "3", "--prompt-len", "6", "--gen-mix", "2,4"]
    tlaunch.main(args + ["--scheduler", "continuous", "--kv", "paged",
                         "--attn", "fused", "--block-size", "4"])
    out = capsys.readouterr().out
    assert "continuous[compressed,paged,fused] on cpu: 8 tokens" in out
    tlaunch.main(args + ["--scheduler", "sequential"])
    out = capsys.readouterr().out.splitlines()
    # the reference's output: the sequential line, then the sample
    assert out[0] == "sequential[compressed]: 8 tokens in 4 decode steps"
    assert out[1].startswith("sample: [")
