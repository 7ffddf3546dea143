"""Port parity for the slotted (slot-per-row) KV layout and the training
forward: ``serve.cache.scatter_slot``, slotted ``decode_step`` (the ring
write and its validity mask, a 0-d position and a per-row [B] vector),
``forward`` / ``loss_fn`` and ``cross_entropy``, the engine's slotted
guards and the CLI's defaults, each against the reference (llama3.2-1b and
deepseek-v2-lite-16b smoke configs, f32, the reference's jax.random
weights carried over through repro_torch.convert, inputs drawn with numpy).
The engines and the sequential oracle are in
``tests/test_torch_slotted_engine.py``.

Tolerances: scatter results and errors, greedy tokens and integer counts
are exact; logits, caches and losses within 1e-4 in f32 (sums in other
orders over a few layers)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_caches as jinit_caches  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.common import cross_entropy as jxent  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpecConfig as JSpec  # noqa: E402
from repro.serve.cache import scatter_slot as jscatter  # noqa: E402
from repro.serve.cache import seed_decode_caches as jseed  # noqa: E402
from _torch_engines import DEEPSEEK, LLAMA, one_thread, pair  # noqa: E402,F401
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import (decode_step, forward, init_caches,  # noqa: E402
                                loss_fn, prefill)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.serve import (ServeEngine, SpecConfig, scatter_slot,  # noqa: E402
                               scatter_slot_, seed_decode_caches)

TOL = dict(rtol=1e-4, atol=1e-4)
_jdecode_jit = jax.jit(jdecode, static_argnums=(1,))
_jprefill_jit = jax.jit(jprefill, static_argnums=(1,))


# -------------------------------------------------------------- scatter_slot

def _both(fn_j, fn_t, *arrays, dtypes):
    """Run the reference and the port on the same numpy inputs."""
    jin = [jnp.asarray(a, d) for a, d in zip(arrays, dtypes)]
    tin = [torch.tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16 if d == jnp.bfloat16 else torch.float32)
        for a, d in zip(arrays, dtypes)]
    return fn_j(*jin), fn_t(*tin)


def test_scatter_slot_n_slots_one_identity_path():
    want, got = _both(lambda p, s: jscatter({"k": p}, {"k": s}, 0),
                      lambda p, s: scatter_slot({"k": p}, {"k": s}, 0),
                      np.zeros((2, 3)), np.ones((2, 3)),
                      dtypes=(jnp.float32, jnp.bfloat16))
    assert got["k"].dtype == torch.float32            # cast to pool dtype
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want["k"]))


def test_scatter_slot_casts_leaf_dtype_on_slot_write():
    rng = np.random.default_rng(0)
    pool, single = rng.normal(size=(4, 2, 3)), rng.normal(size=(1, 2, 3))
    want, got = _both(lambda p, s: jscatter(p, s, 2),
                      lambda p, s: scatter_slot(p, s, 2), pool, single,
                      dtypes=(jnp.float32, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the pure form leaves the pool alone; the in-place one writes it
    tpool = torch.tensor(pool, dtype=torch.float32)
    before = tpool.clone()
    scatter_slot(tpool, torch.tensor(single, dtype=torch.bfloat16), 2)
    assert torch.equal(tpool, before)
    ptr = tpool.data_ptr()
    out = scatter_slot_(tpool, torch.tensor(single, dtype=torch.bfloat16), 2)
    assert out is tpool and tpool.data_ptr() == ptr
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(want))


@pytest.mark.parametrize("pool,single", [((4, 2, 3), (1, 5, 3)),
                                         ((4, 2, 3), (2, 3))])
def test_scatter_slot_rejects_what_the_reference_rejects(pool, single):
    """More than one differing axis, or a rank mismatch: both raise
    ValueError naming the slot axis; the in-place form writes nothing."""
    with pytest.raises(ValueError, match="slot axis"):
        jscatter(jnp.zeros(pool), jnp.ones(single), 0)
    with pytest.raises(ValueError, match="slot axis"):
        scatter_slot(torch.zeros(pool), torch.ones(single), 0)
    tree = {"a": torch.zeros((4, 2, 3)), "b": torch.zeros(pool)}
    with pytest.raises(ValueError, match="slot axis"):
        scatter_slot_(tree, {"a": torch.ones((1, 2, 3)),
                             "b": torch.ones(single)}, 0)
    assert not tree["a"].any()


@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK])
def test_seeded_single_row_scatters_like_reference(arch):
    """Admission's cache path: a batch-1 prefill seeded into a one-row
    cache and scattered into slot 1 of a 3-slot pool."""
    jc, params, tc, model = pair(arch)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (1, 7))
    _, jpf = _jprefill_jit(params, jc, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)})
    jsingle = jseed(jc, jinit_caches(jc, 1, 12)[0], jpf)
    want = jscatter(jinit_caches(jc, 3, 12)[0], jsingle, 1)
    _, pf = prefill(model, tc, {"tokens": torch.tensor(toks)})
    pool = init_caches(tc, 3, 12, device="cpu")
    scatter_slot_(pool, seed_decode_caches(
        tc, init_caches(tc, 1, 12, device="cpu"), pf), 1)
    for name in want:
        np.testing.assert_allclose(pool[name].numpy(),
                                   np.asarray(want[name]), **TOL)


# ------------------------------------------------------------ slotted decode

def _seeded(jc, params, tc, model, b=2, plen=9, max_len=16):
    """Reference and port slotted caches seeded from one prefill of ``b``
    rows x ``plen`` tokens, and the port's copy of the reference's."""
    toks = np.random.default_rng(2).integers(0, jc.vocab, (b, plen))
    _, jpf = _jprefill_jit(params, jc, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)})
    jc_ = jseed(jc, jinit_caches(jc, b, max_len)[0], jpf)
    _, pf = prefill(model, tc, {"tokens": torch.tensor(toks)})
    tc_ = seed_decode_caches(tc, init_caches(tc, b, max_len, device="cpu"),
                             pf)
    for name in jc_:
        np.testing.assert_allclose(tc_[name].numpy(), np.asarray(jc_[name]),
                                   **TOL)
    return jc_, {n: torch.tensor(np.asarray(v)) for n, v in jc_.items()}


@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK])
@pytest.mark.parametrize("vector", [False, True])
def test_slotted_decode_steps_match(arch, vector):
    """Four decode ticks over seeded slotted caches, the whole batch at one
    0-d position or rows at their own [B] positions: logits, greedy tokens
    and the caches (written in place) agree."""
    jc, params, tc, model = pair(arch)
    jcache, tcache = _seeded(jc, params, tc, model)
    ptrs = [t.data_ptr() for t in tcache.values()]
    tok = np.array([3, 77], np.int32)
    pos = np.array([9, 6], np.int32) if vector else np.int32(9)
    for _ in range(4):
        lj, jcache = _jdecode_jit(params, jc, jcache, jnp.asarray(tok),
                                  jnp.asarray(pos))
        lt, out = decode_step(model, tc, tcache, torch.tensor(tok).long(),
                              torch.tensor(pos))
        assert out is tcache
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        np.testing.assert_array_equal(tok, lt.argmax(-1).numpy())
        pos = pos + 1
    assert [t.data_ptr() for t in tcache.values()] == ptrs
    for name in jcache:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


@pytest.mark.parametrize("vector", [False, True])
def test_ring_write_wraps_with_window_and_softcap(vector):
    """The ring arithmetic the windowed (gemma2) layers read: a 6-slot
    ring decoded to position 13 (two wraps) under window 4 and softcap 20,
    one GQA layer against the reference's, outputs and ring each step."""
    jc, params, tc, model = pair(LLAMA)
    jc, tc = (c.replace(softcap_attn=20.0) for c in (jc, tc))
    jp = jax.tree.map(lambda a: a[0], params["layers"])["attn"]
    tp = model.layers[0].attn
    rng = np.random.default_rng(3)
    shape = (2, 6, tc.n_kv, tc.hd())
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for p in range(14):
        x = rng.normal(size=(2, 1, tc.d_model)).astype(np.float32)
        pos = np.array([p, p + 3], np.int32) if vector else np.int32(p)
        yj, jcache = jattn.gqa_apply(jp, jnp.asarray(x), jc,
                                     positions=jnp.asarray(pos), window=4,
                                     cache=jcache, cache_pos=jnp.asarray(pos))
        yt, _ = tattn.gqa_apply(tp, torch.tensor(x), tc,
                                positions=torch.tensor(pos), window=4,
                                cache=tcache, cache_pos=torch.tensor(pos))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)


def test_slotted_decode_takes_one_token_per_row():
    _, _, tc, model = pair(LLAMA)
    cache = {n: t[0] for n, t in init_caches(tc, 2, 8, device="cpu").items()}
    x = torch.zeros((2, 3, tc.d_model))
    with pytest.raises(ValueError, match="one token per row"):
        tattn.gqa_apply(model.layers[0].attn, x, tc,
                        positions=torch.tensor([0, 0], dtype=torch.int32),
                        cache=cache, cache_pos=torch.tensor([0, 0]))


# ------------------------------------------------------- forward / loss_fn

def _batch(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1                                 # ignored
    labels[0, 3] = -1
    return toks, labels


@pytest.mark.parametrize("arch,compressed", [(LLAMA, False), (LLAMA, True),
                                             (DEEPSEEK, False)])
def test_forward_and_loss_match(arch, compressed):
    """Full-sequence logits [B, S, V] (f32), the MoE aux (the mean over the
    MoE layers), the masked mean NLL and the total loss."""
    jc, params, tc, model = pair(arch, compressed)
    toks, labels = _batch(jc, 4)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.tensor(toks).long(),
          "labels": torch.tensor(labels).long()}
    lj, aux_j = jax.jit(jforward, static_argnums=(1,))(params, jc, jb)
    lt, aux_t = forward(model, tc, tb)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    if jc.family == "moe":
        assert float(aux_t) > 0
    total_j, parts_j = jax.jit(jloss, static_argnums=(1,))(params, jc, jb)
    total_t, parts_t = loss_fn(model, tc, tb)
    for got, want in ((total_t, total_j), (parts_t["loss"], parts_j["loss"]),
                      (parts_t["moe_aux"], parts_j["moe_aux"])):
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_cross_entropy_matches_reference():
    """Masked mean NLL in f32 from f32 or bf16 logits; all labels masked
    gives 0, not a division by zero."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7))
    labels[1, 2:] = -1
    for lab in (labels, np.full_like(labels, -1)):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = jxent(jnp.asarray(logits, jdt), jnp.asarray(lab))
            got = cross_entropy(torch.tensor(logits).to(tdt),
                                torch.tensor(lab))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), **TOL)


# ------------------------------------------------------------ engine guards

@pytest.mark.parametrize("kw", [dict(attn="fused"), dict(prefix_cache=True),
                                dict(spec="skip")])
def test_slotted_engine_guards_match_reference(kw):
    """kv="slotted" (the default of both) with the fused read, the prefix
    cache or speculation raises the reference's ValueError."""
    jc, params, tc, model = pair(LLAMA)
    draft = kw.get("spec")
    jkw = dict(kw, spec=JSpec(draft=draft)) if draft else kw
    tkw = dict(kw, spec=SpecConfig(draft=draft)) if draft else kw
    with pytest.raises(ValueError) as want:
        JEngine(params, jc, n_slots=1, max_len=8, **jkw)
    with pytest.raises(ValueError) as got:
        ServeEngine(model, tc, n_slots=1, max_len=8, device="cpu", **tkw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="kv must be"):
        ServeEngine(model, tc, n_slots=1, max_len=8, kv="rows", device="cpu")


def test_engine_defaults_to_the_slotted_layout():
    _, _, tc, model = pair(LLAMA)
    eng = ServeEngine(model, tc, n_slots=2, max_len=8, device="cpu")
    assert eng.kv == "slotted" and eng.pool is None
    assert eng.executable_shapes() == {"prefill_buckets": (),
                                       "entries": {"decode": 1}, "total": 1}


# ---------------------------------------------------------------------- CLI

def test_cli_defaults_are_the_reference_ones(capsys):
    """No flags: the sequential oracle over the slotted layout with the
    gather read; a slotted continuous run; and the reference's guards."""
    base = ["--arch", LLAMA, "--smoke", "--device", "cpu", "--slots", "2",
            "--requests", "3", "--prompt-len", "6", "--gen-mix", "2,4"]
    tlaunch.main(base)
    out = capsys.readouterr().out
    assert "sequential[compressed]: 8 tokens in 4 decode steps" in out
    tlaunch.main(base + ["--scheduler", "continuous"])
    out = capsys.readouterr().out
    assert "continuous[compressed,slotted,gather] on cpu: 8 tokens" in out
    assert "paged pool" not in out
    for extra, msg in ((["--kv", "paged"], "--kv paged requires"),
                       (["--attn", "fused"], "--attn fused requires"),
                       (["--prewarm"], "--prewarm requires"),
                       (["--spec"], "--spec requires"),
                       (["--prefix-cache"], "--prefix-cache")):
        with pytest.raises(SystemExit, match=msg):
            tlaunch.main(base + extra)


def test_cli_sequential_dense_weights_match_compressed_tokens(capsys):
    """``--weights dense`` serves the same model unconverted (a masked
    dense forward): at smoke size the greedy tokens agree."""
    base = ["--arch", LLAMA, "--smoke", "--device", "cpu", "--slots", "2",
            "--requests", "2", "--prompt-len", "6", "--gen", "4"]
    tlaunch.main(base)
    comp = capsys.readouterr().out.split("sample:")[1]
    tlaunch.main(base + ["--weights", "dense"])
    out = capsys.readouterr().out
    assert "sequential[dense]: 8 tokens in 3 decode steps" in out
    assert out.split("sample:")[1] == comp
