"""Port parity for the cold-start module (``repro_torch.serve.prewarm``) and
the engine's prewarm contract, after the reference's ``tests/test_prewarm.py``
(the cases that need no mesh or slotted layout; prefix caching and suspend
run through the same graphed decode, ``tests/test_torch_prefix.py``).

On the CPU an entry point runs its function directly, with the same shape
keys, static-buffer copies and capture accounting as on the card, so what
is checked here is everything but capture and replay (those are card
tests in ``tests/test_torch_cuda.py``; the strict prewarmed engine
against the lazy and the reference engine is in
``tests/test_torch_prewarm_engine.py``):
* ``prewarm()`` is idempotent; strict mode raises on a lazy engine;
* ``executable_shapes()`` equals the reference engine's;
* the counters account for every entry point; ``abstract_batch`` keys the
  admitted prompts;
* the hoisted per-forward invariants and the device-index ``logit_pos``
  give the same bits as before; the scatter-add expert counts equal
  ``torch.bincount``; ``graphs=True`` on the CPU raises.
Token streams and counters are exact."""

import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpecConfig as JSpec  # noqa: E402
from _torch_engines import DEEPSEEK, LLAMA, one_thread  # noqa: E402,F401
from _torch_engines import pair as _pair  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import decode_step, prefill, verify_step  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models.transformer import _block_apply  # noqa: E402
from repro_torch.serve import (BlockPool, ServeEngine, SpecConfig,  # noqa: E402
                               synthetic_request)
from repro_torch.serve.prewarm import (CompileLog, GraphEntry,  # noqa: E402
                                       _shape_key, abstract, abstract_batch,
                                       batch_prompt, enable_compile_cache)

CPU = torch.device("cpu")


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


# ------------------------------------------------------- zero-capture serving

def test_prewarm_is_idempotent_and_covers_replayed_trace():
    """A second prewarm() builds nothing new, and a second trace over other
    admissible lengths still hits only prewarmed shapes."""
    _, _, tc, model = _pair(LLAMA)
    eng = ServeEngine(model, tc, n_slots=2, max_len=20, kv="paged",
                      block_size=4, compressed=True, attn="fused",
                      device="cpu", prewarm=True, strict_prewarm=True)
    before = eng.stats()["prewarmed_executables"]
    eng.prewarm()
    assert eng.stats()["prewarmed_executables"] == before
    assert len(eng.compile_events()) == before
    eng.run(_trace(tc, [3, 11, 7], [5, 4, 6], synthetic_request))
    eng.run(_trace(tc, [20, 1], [1, 1], synthetic_request, seed=6))
    assert eng.stats()["mid_serve_compiles"] == 0


def test_strict_mode_raises_on_lazy_engine():
    _, _, tc, model = _pair(LLAMA)
    eng = ServeEngine(model, tc, n_slots=2, max_len=16, kv="paged",
                      block_size=4, device="cpu", strict_prewarm=True)
    with pytest.raises(RuntimeError, match="mid-serve compile"):
        eng.run(_trace(tc, [5], [4], synthetic_request))


# --------------------------------------------------------- shape enumeration

@pytest.mark.parametrize("spec", [None, "skip"])
def test_executable_shapes_equal_reference(spec):
    """One enumeration, equal to the reference engine's for the same
    config: the bucket set is closed (max_len appended), admitted prefill
    lengths are a subset of it, and prewarm built exactly its total."""
    jc, params, tc, model = _pair(LLAMA)
    kw = dict(n_slots=3, max_len=24, kv="paged", block_size=4,
              prefill_buckets=(4, 16))
    jeng = JEngine(params, jc, spec=spec and JSpec(k=2, draft=spec), **kw)
    eng = ServeEngine(model, tc, spec=spec and SpecConfig(k=2, draft=spec),
                      device="cpu", prewarm=True, strict_prewarm=True, **kw)
    shapes = eng.executable_shapes()
    assert shapes == jeng.executable_shapes()
    assert shapes["prefill_buckets"] == (4, 16, 24)
    assert eng.prefill_buckets == shapes["prefill_buckets"]
    assert eng.stats()["prewarmed_executables"] == shapes["total"]
    eng.run(_trace(tc, [3, 17, 9], [4, 4, 4], synthetic_request))
    assert eng.prefill_lengths <= set(shapes["prefill_buckets"])
    assert eng.stats()["mid_serve_compiles"] == 0


def test_compile_counters_account_every_entry_point():
    """A lazy spec engine's bill: one decode, propose and verify shape and
    one prefill shape per admitted bucket, all mid-serve."""
    _, _, tc, model = _pair(LLAMA)
    eng = ServeEngine(model, tc, n_slots=2, max_len=20, kv="paged",
                      block_size=4, compressed=True, attn="fused",
                      device="cpu", spec=SpecConfig(k=2, draft="rerank"))
    # rid 1 opts out of speculation so the plain-decode row runs too
    eng.run(_trace(tc, [5, 9], [4, 5], synthetic_request, spec_off=(1,)))
    st = eng.stats()
    assert st["decode_compiles"] == 1
    assert st["propose_compiles"] == 1
    assert st["verify_compiles"] == 1
    assert st["prefill_compiles"] == len(eng.prefill_lengths) > 0
    assert st["mid_serve_compiles"] == (
        st["decode_compiles"] + st["propose_compiles"]
        + st["verify_compiles"] + st["prefill_compiles"])
    assert {e["phase"] for e in eng.compile_events()} == {"serve"}
    calls = sum(e.calls for e in eng.entries.values())
    assert st["warm_calls"] == calls - st["mid_serve_compiles"] > 0
    assert eng.entries["verify"].calls <= st["decode_steps"]
    assert st["first_tick_s"] > 0 and st["steady_tick_s"] > 0
    assert st["init_seconds"] >= st["prewarm_seconds"] == 0.0


def test_abstract_batch_matches_admitted_shapes():
    """The prewarm-side builder and admission give the same dispatch key,
    bucket down or pad up."""
    _, _, tc, model = _pair(LLAMA)
    rng = np.random.default_rng(0)
    for b in (4, 8, 16):
        toks = rng.integers(0, tc.vocab, (b,)).astype(np.int32)
        lp = torch.tensor(b - 1, dtype=torch.long)
        assert (_shape_key((abstract_batch(tc, b), abstract((), torch.long)))
                == _shape_key((batch_prompt({"tokens": toks}), lp)))
    eng = ServeEngine(model, tc, n_slots=2, max_len=16, kv="paged",
                      block_size=4, device="cpu", prewarm=True,
                      strict_prewarm=True)
    eng.run(_trace(tc, [6, 13, 2], [3, 3, 2], synthetic_request))
    assert eng.stats()["mid_serve_compiles"] == 0


# ----------------------------------------------------------- the entry point

def test_shape_key_ignores_dict_insertion_order():
    a = {"tokens": torch.zeros((1, 4), dtype=torch.long),
         "embeds": torch.zeros((1, 4, 8))}
    b = dict(reversed(list(a.items())))
    assert _shape_key((a,)) == _shape_key((b,))
    meta = {k: abstract(v.shape, v.dtype) for k, v in a.items()}
    assert _shape_key((meta,)) == _shape_key((a,))
    assert _shape_key((a,)) != _shape_key(({"tokens": a["tokens"]},))


def test_graph_entry_dispatch_and_capture_accounting():
    """Without graphs: a prewarmed shape dispatches warm, an unseen one
    is built (a mid-serve compile once serving), and every call copies its
    arguments into the shape's static buffers."""
    log = CompileLog()
    seen = []

    def fn(x):
        seen.append(x)
        return x * 2
    entry = GraphEntry("f", fn, device=CPU, graphs=False, log=log)
    assert entry.capture(abstract((4,), torch.float32), label="x4")
    assert not entry.capture(abstract((4,), torch.float32))
    assert entry(torch.ones(4)).tolist() == [2.0] * 4
    assert entry(torch.full((4,), 3.0)).tolist() == [6.0] * 4
    assert seen[0] is seen[1]                # one static buffer per shape
    assert entry.warm_calls == 2 and entry.n_compiles == 1
    log.serving = True
    entry(torch.ones(8))                     # an uncovered shape
    assert entry.n_compiles == 2 and log.mid_serve_compiles == 1
    assert log.prewarm_compiles == 1 and entry.calls == 3
    log.strict = True
    with pytest.raises(RuntimeError, match="mid-serve compile of f"):
        entry(torch.ones(2))


def test_graph_replays_add_the_captured_transport_bytes(monkeypatch):
    """A capture sends nothing: the bytes its collectives counted are
    taken back, and every replay adds them to the mesh's counters (also
    after ``reset_stats``).  The CUDA graph calls are stand-ins, so the
    accounting runs here as it does on the card."""
    from repro_torch.dist.api import ServeMesh
    from repro_torch.serve import prewarm

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    class Stream:
        def wait_stream(self, other):
            pass

        def synchronize(self):
            pass
    none = contextlib.nullcontext
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: none())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: none())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    monkeypatch.setattr(prewarm, "_sync_debug_error", none)
    mesh = ServeMesh(size=2, rank=0, device=CPU, backend="nccl")
    calls = []

    def fn(x):                   # one ring step's send and one all-gather
        calls.append(x)
        mesh.stats["ring_bytes"] += 96
        mesh.stats["gather_bytes"] += 16
        return x + 1
    entry = GraphEntry("decode", fn, device=CPU, graphs=False,
                       stream=Stream(), counters=mesh.stats)
    entry.graphs = True
    entry(torch.zeros(4))                    # warm-up (sends) + capture
    assert len(calls) == 2 and Graph.replays == 0
    assert mesh.stats == {"ring_bytes": 96, "gather_bytes": 16,
                          "staged_bytes": 0}
    entry(torch.zeros(4))
    entry(torch.zeros(4))
    assert len(calls) == 2 and Graph.replays == 2
    assert mesh.stats["ring_bytes"] == 3 * 96
    assert mesh.stats["gather_bytes"] == 3 * 16
    mesh.reset_stats()
    entry(torch.zeros(4))
    assert mesh.stats == {"ring_bytes": 96, "gather_bytes": 16,
                          "staged_bytes": 0}


def test_graphs_need_a_cuda_device():
    _, _, tc, model = _pair(LLAMA)
    with pytest.raises(ValueError, match="CUDA device"):
        ServeEngine(model, tc, n_slots=1, max_len=8, device="cpu",
                    graphs=True)
    with pytest.raises(ValueError, match="CUDA device"):
        GraphEntry("f", lambda x: x, device=CPU, graphs=True)
    assert ServeEngine(model, tc, n_slots=1, max_len=8,
                       device="cpu").graphs is False


def test_compile_cache_names_the_kernel_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)   # restored
    monkeypatch.setattr(build, "_LIBS", {})
    assert enable_compile_cache(tmp_path / "k") == str(tmp_path / "k")
    assert build.BUILD_DIR == tmp_path / "k" and (tmp_path / "k").is_dir()
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path / "env"))
    assert enable_compile_cache(True) == str(tmp_path / "env")
    build._LIBS["nm_spmv"] = object()        # a library is loaded now
    with pytest.raises(RuntimeError, match="already loaded"):
        enable_compile_cache(tmp_path / "other")
    assert enable_compile_cache(tmp_path / "env") == str(tmp_path / "env")


# --------------------------------------------- the model path, made capturable

@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK])
@pytest.mark.parametrize("span", [1, 3])
def test_hoisted_invariants_are_bit_equal(arch, span):
    """decode_step / verify_step (RoPE angles, kv_len and the span write's
    cells computed once per forward) against the blocks each computing
    their own: equal logits and pools, bit for bit."""
    _, _, tc, model = _pair(arch)
    pool = BlockPool(tc, 3, 16, 4, device="cpu")
    for slot, n in enumerate((2, 3)):
        pool.alloc(slot, n)
    g = torch.Generator().manual_seed(span)
    for leaf in pool.caches.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    tok = torch.randint(0, tc.vocab, (3, span), generator=g)
    pos = torch.tensor([5, 7, 0], dtype=torch.int32)   # row 2 idle (trash)
    tbl = torch.from_numpy(pool.table)
    cfg = tc.replace(attn_impl="fused")
    mine = {k: v.clone() for k, v in pool.caches.items()}
    fn = decode_step if span == 1 else verify_step
    got, _ = fn(model, cfg, pool.caches, tok[:, 0] if span == 1 else tok,
                pos, tbl)
    x = model.embed.emb[tok]
    for i, lp in enumerate(model.blocks()):
        layer = {name: leaf[i] for name, leaf in mine.items()}
        x, _ = _block_apply(lp, x, cfg, positions=pos, cache=layer,
                            cache_pos=pos, block_table=tbl)
    from repro_torch.models.common import lm_head_apply, rms_norm
    want = lm_head_apply(model.embed, rms_norm(model.lnf, x, cfg.norm_eps),
                         cfg.softcap_final)
    assert torch.equal(got.reshape(want.shape), want)
    for name in mine:
        assert torch.equal(pool.caches[name], mine[name]), name


def test_prefill_logit_pos_as_device_index_is_bit_equal():
    _, _, tc, model = _pair(DEEPSEEK)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab, (1, 8))).long()
    for lp in (0, 4, 7):
        a, ca = prefill(model, tc, {"tokens": toks}, logit_pos=lp)
        b, cb = prefill(model, tc, {"tokens": toks},
                        logit_pos=torch.tensor(lp))
        assert torch.equal(a, b)
        for stack in ca:
            for name in ca[stack]:
                assert torch.equal(ca[stack][name], cb[stack][name])


@pytest.mark.parametrize("e,n", [(4, 1), (6, 37), (64, 96)])
def test_expert_counts_equal_bincount(e, n):
    ids = torch.from_numpy(np.random.default_rng(e + n).integers(
        0, e, (n,))).long()
    got = ffn.expert_counts(ids, e)
    assert got.dtype == torch.long
    assert torch.equal(got, torch.bincount(ids, minlength=e))


# -------------------------------------------------------------------- CLI

def test_cli_prewarm_prints_the_compile_line(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)   # restored
    tlaunch.main(["--arch", LLAMA, "--smoke", "--device", "cpu",
                  "--scheduler", "continuous", "--kv", "paged",
                  "--attn", "fused", "--slots", "2", "--requests", "3",
                  "--prompt-len", "6", "--gen-mix", "2,4", "--block-size",
                  "4", "--prewarm",
                  "--compile-cache", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"compile cache: {tmp_path}" in out
    # max_len 10: buckets 4, 8, 10 and the decode shape
    assert "compile[prewarmed, eager]: 4 prewarmed + 0 mid-serve of 4 " \
           "expected executables" in out
    assert "on cpu: 8 tokens" in out
