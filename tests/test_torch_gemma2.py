"""Port parity for gemma2-9b (local / global pairs, attention and final
softcaps, post norms, the zero-centered norm, sqrt(d)-scaled embeddings,
the tanh gelu): ``forward`` / ``loss_fn``, ``prefill``, slotted
``decode_step`` over the local rings, paged ``decode_step`` (the gather
read and the fused kernel's plain route) and ``verify_step``, each against
the reference on the smoke config (f32, window 32, the reference's
jax.random weights carried over through repro_torch.convert, inputs drawn
with numpy).  The engines are in ``tests/test_torch_gemma2_engine.py``.

The ring seeding regression: the reference seeds a local ring with the
prompt's last L positions at indices 0..L-1, while its read takes slot j
to hold position ``pos - ((pos - j) mod L)``; a prompt longer than the
window and not a multiple of it then decodes wrong on the reference's
slotted path.  The port seeds position p at index p mod L, and its
slotted decode is held to the reference's ``forward`` there.

Tolerances: logits, caches and losses within 1e-4 in f32 (sums in other
orders over 4 layers); greedy tokens exact; the reference's own slotted
miss is asserted above 0.1 (it is O(1))."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_caches as jinit_caches  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import verify_step as jverify  # noqa: E402
from repro.serve.cache import seed_decode_caches as jseed  # noqa: E402
from _torch_engines import one_thread, pair  # noqa: E402,F401
from repro_torch.models import (decode_step, forward, init_caches,  # noqa: E402
                                init_model, loss_fn, prefill, verify_step)
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.serve import seed_decode_caches  # noqa: E402

GEMMA = "gemma2-9b"
TOL = dict(rtol=1e-4, atol=1e-4)
_jforward = jax.jit(jforward, static_argnums=(1,))
_jprefill = jax.jit(jprefill, static_argnums=(1,))
_jdecode = jax.jit(jdecode, static_argnums=(1,), static_argnames="attn_impl")
_jverify = jax.jit(jverify, static_argnums=(1,), static_argnames="attn_impl")
_jloss = jax.jit(jloss, static_argnums=(1,))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _np(x):
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ building blocks

def test_gelu_is_the_references_tanh_form():
    x = np.linspace(-4, 4, 4001, dtype=np.float32)
    want = _np(jcommon.ACTIVATIONS["gelu"](jnp.asarray(x)))
    got = tcommon.ACTIVATIONS["gelu"](torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(zero_centered, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jcommon.rms_norm({"scale": jnp.asarray(scale)},
                            jnp.asarray(x, jd), 1e-6,
                            zero_centered=zero_centered)
    got = tcommon.rms_norm(tcommon.RMSNorm(torch.tensor(scale)),
                           torch.tensor(x).to(td), 1e-6,
                           zero_centered=zero_centered)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL)


def test_scaled_embeddings_round_sqrt_d_to_the_dtype_first():
    """gemma2-9b's d 3584 in bf16: x * sqrt(d) with sqrt(d) rounded to bf16
    first (59.75, not 59.8665), bit for bit the reference's."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer as ttransformer
    from repro_torch.configs import get_config as tget
    from repro.configs import get_config as jget
    jc, tc = jget(GEMMA), tget(GEMMA)
    emb = np.random.default_rng(0).normal(size=(16, jc.d_model)).astype(
        np.float32)
    toks = np.array([[3, 0, 15, 7]])
    want = jtransformer._embed_in({"embed": {"emb": jnp.asarray(
        emb, jnp.bfloat16)}}, jc, {"tokens": jnp.asarray(toks)})
    model = tcommon.Embedding(torch.tensor(emb).to(torch.bfloat16))
    got = ttransformer._embed(type("M", (), {"embed": model})(), tc,
                              torch.tensor(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    assert torch.tensor(jc.d_model ** 0.5, dtype=torch.bfloat16).item() \
        == 59.75


@pytest.mark.parametrize("window,cap", [(None, None), (20, 50.0)])
def test_chunked_attention_pads_a_length_without_a_good_divisor(
        monkeypatch, window, cap):
    """A prompt of prime length 131 (as 4168 = 8 x 521 is at full width):
    the reference's picker falls to chunks of 1, and the port's Python
    loop would run 131 x 131 chunk pairs; it pads to the 64-position chunk
    instead and skips the pairs the causal mask or the window masks
    everywhere, within 1e-5 of the reference's chunked_attention."""
    from repro.models.attention import chunked_attention as jchunked
    from repro_torch.models.attention import chunked_attention
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 131, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    want = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, window=window, cap=cap, q_chunk=64,
                    kv_chunk=64)
    calls = []
    einsum = torch.einsum
    monkeypatch.setattr(torch, "einsum",
                        lambda *a: calls.append(1) or einsum(*a))
    got = chunked_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                            causal=True, window=window, cap=cap, q_chunk=64,
                            kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    pairs = 3 * 4 // 2 if window is None else 3 + 2
    assert len(calls) == 2 * pairs


def test_converted_tree_matches_reference():
    """Block 2i is the reference's pairs["local"][i], 2i + 1 its
    pairs["global"][i], post norms included."""
    jc, params, tc, model = pair(GEMMA)
    blocks = model.blocks()
    assert len(blocks) == jc.n_layers
    for i, blk in enumerate(blocks):
        ref = jax.tree.map(lambda a: np.asarray(a)[i // 2],
                           params["pairs"]["local" if i % 2 == 0
                                           else "global"])
        for name in ("ln1", "ln2", "pn1", "pn2"):
            np.testing.assert_array_equal(getattr(blk, name).scale.numpy(),
                                          ref[name]["scale"])
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(getattr(blk.attn, name).w.numpy(),
                                          ref["attn"][name]["w"])
        for name in ("wg", "wu", "wd"):
            np.testing.assert_array_equal(getattr(blk.mlp, name).w.numpy(),
                                          ref["mlp"][name]["w"])
    np.testing.assert_array_equal(model.embed.emb.numpy(),
                                  np.asarray(params["embed"]["emb"]))


def test_init_model_builds_post_norms_and_pairs():
    tc = pair(GEMMA)[2]
    model = init_model(tc, seed=0, device="cpu")
    assert all(b.pn1 is not None and b.pn2 is not None
               for b in model.blocks())
    caches = init_caches(tc, 2, 48, device="cpu")
    assert caches["local"]["k"].shape == (2, 2, 32, 4, 64)
    assert caches["global"]["k"].shape == (2, 2, 48, 4, 64)
    flat = init_caches(tc, 2, 48, device="cpu", ring=False)
    assert flat["k"].shape == (4, 2, 48, 4, 64)


# ------------------------------------------------------- forward / prefill

def test_forward_and_loss_match_reference():
    """A 40-token sequence: the local layers' window (32) masks its tail."""
    jc, params, tc, model = pair(GEMMA)
    toks = _tokens(0, 2, 40, jc.vocab)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    lj, _ = _jforward(params, jc, {"tokens": jnp.asarray(toks)})
    lt, aux = forward(model, tc, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    assert float(aux) == 0.0
    (loss_j, _), (loss_t, parts) = (
        _jloss(params, jc, {k: jnp.asarray(v) for k, v in batch.items()}),
        loss_fn(model, tc, {k: torch.tensor(v) for k, v in batch.items()}))
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    np.testing.assert_allclose(float(parts["loss"]), float(loss_j), **TOL)


@pytest.mark.parametrize("logit_pos", [None, 17])
def test_prefill_logits_and_caches_match(logit_pos):
    """The port's flat [L, ...] prefill stack holds the reference's local
    layers at 0::2 and its global layers at 1::2."""
    jc, params, tc, model = pair(GEMMA)
    toks = _tokens(1, 2, 36, jc.vocab)
    lj, cj = jprefill(params, jc, {"tokens": jnp.asarray(toks)},
                      logit_pos=None if logit_pos is None
                      else jnp.asarray(logit_pos))
    lt, ct = prefill(model, tc, {"tokens": torch.tensor(toks)},
                     logit_pos=logit_pos)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    for kind, first in (("local", 0), ("global", 1)):
        for name in ("k", "v"):
            np.testing.assert_allclose(ct[name][first::2].numpy(),
                                       _np(cj[kind][name]), **TOL)


# ----------------------------------------------------------- slotted decode

def _both_seeded(toks, max_len=48):
    """Reference and port slotted caches seeded from one prefill of
    ``toks`` [B, plen]."""
    jc, params, tc, model = pair(GEMMA)
    b = toks.shape[0]
    _, cj = _jprefill(params, jc, {"tokens": jnp.asarray(toks)})
    jcache = jseed(jc, jinit_caches(jc, b, max_len)[0], cj)
    _, ct = prefill(model, tc, {"tokens": torch.tensor(toks)})
    tcache = seed_decode_caches(tc, init_caches(tc, b, max_len,
                                                device="cpu"), ct)
    return jcache, tcache


@pytest.mark.parametrize("vector", [False, True])
def test_slotted_decode_matches_reference_inside_the_window(vector):
    """Prompt 20 < window 32: both seed the ring alike.  Four ticks, the
    batch at one 0-d position or rows at their own [B] positions; the
    port's local ring wraps at position 32 as the reference's does."""
    jc, params, tc, model = pair(GEMMA)
    jcache, tcache = _both_seeded(_tokens(2, 2, 20, jc.vocab))
    for kind in ("local", "global"):
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[kind][name].numpy(),
                                       _np(jcache[kind][name]), **TOL)
    ptrs = [t.data_ptr() for kind in tcache.values() for t in kind.values()]
    tok = np.array([3, 77], np.int32)
    pos = np.array([20, 14], np.int32) if vector else np.int32(20)
    for _ in range(14):
        lj, jcache = _jdecode(params, jc, jcache, jnp.asarray(tok),
                              jnp.asarray(pos))
        lt, tcache = decode_step(model, tc, tcache, torch.tensor(tok).long(),
                                 torch.tensor(pos))
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        np.testing.assert_array_equal(tok, lt.argmax(-1).numpy())
        pos = pos + 1
    assert ptrs == [t.data_ptr() for kind in tcache.values()
                    for t in kind.values()]            # written in place
    for kind in ("local", "global"):
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[kind][name].numpy(),
                                       _np(jcache[kind][name]), **TOL)


@pytest.mark.parametrize("plen", [40, 48, 64])
def test_ring_seeding_matches_forward_past_the_window(plen):
    """Prompt > window 32: the port's slotted decode at position ``plen``
    equals the reference's ``forward`` over plen + 1 tokens within 1e-4.
    At 40 and 48 (not multiples of 32) the reference's own slotted path
    misses by O(1): its ring is seeded at 0..L-1."""
    jc, params, tc, model = pair(GEMMA)
    toks = _tokens(5, 2, plen + 1, jc.vocab)
    want = _np(_jforward(params, jc, {"tokens": jnp.asarray(toks)})[0])[:, -1]
    jcache, tcache = _both_seeded(toks[:, :plen], max_len=96)
    lt, _ = decode_step(model, tc, tcache, torch.tensor(toks[:, plen]),
                        torch.tensor(plen, dtype=torch.int32))
    np.testing.assert_allclose(lt.numpy(), want, **TOL)
    lj, _ = _jdecode(params, jc, jcache, jnp.asarray(toks[:, plen],
                                                     jnp.int32),
                     jnp.int32(plen))
    miss = float(np.abs(_np(lj) - want).max())
    if plen % 32:
        assert miss > 0.1, miss
    else:
        assert miss < 1e-4, miss


def test_ring_seeding_puts_position_p_at_p_mod_L():
    tc = pair(GEMMA)[2]
    caches = init_caches(tc, 1, 96, device="cpu")
    pf = {n: torch.arange(40, dtype=torch.float32).reshape(1, 1, 40, 1, 1)
          .expand(4, 1, 40, 4, 64).contiguous() for n in ("k", "v")}
    seeded = seed_decode_caches(tc, caches, pf)
    ring = seeded["local"]["k"][0, 0, :, 0, 0]
    assert ring.tolist() == [float(32 + j) if j < 8 else float(j)
                             for j in range(32)]
    glob = seeded["global"]["k"][0, 0, :, 0, 0]
    assert glob[:40].tolist() == list(map(float, range(40)))
    assert not glob[40:].any()
    # src_len clips the bucket padding before the ring is cut
    clipped = seed_decode_caches(tc, caches, pf, src_len=33)
    assert clipped["local"]["k"][0, 0, :, 0, 0].tolist() == \
        [32.0] + [float(j) for j in range(1, 32)]


# ------------------------------------------------------------- paged decode

def _pools(plen=36, bs=4, n_blocks=30, width=12, seed=3):
    """Reference pools ({"local", "global"} [L/2, n_blocks, bs, ...]) and
    the port's flat [L, ...] pools seeded with one prefill through a
    shuffled table; row 2 idle (all trash)."""
    jc, params, tc, model = pair(GEMMA)
    toks = _tokens(seed, 2, plen, jc.vocab)
    _, cj = _jprefill(params, jc, {"tokens": jnp.asarray(toks)})
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_blocks))
    tbl = np.zeros((3, width), np.int32)
    tbl[0] = perm[:width]
    tbl[1] = perm[width:2 * width]
    jpool = {}
    for kind in ("local", "global"):
        jpool[kind] = {}
        for name in ("k", "v"):
            c = _np(cj[kind][name])                    # [L/2, B, S, kv, hd]
            pool = np.zeros((c.shape[0], n_blocks, bs) + c.shape[3:],
                            np.float32)
            for row in range(2):
                for p in range(plen):
                    pool[:, tbl[row, p // bs], p % bs] = c[:, row, p]
            jpool[kind][name] = pool
    flat = {}
    for name in ("k", "v"):
        both = np.empty((jc.n_layers,) + jpool["local"][name].shape[1:],
                        np.float32)
        both[0::2], both[1::2] = jpool["local"][name], jpool["global"][name]
        flat[name] = torch.tensor(both)
    return tbl, jpool, flat


def _same_pools(tpool, jpool, tbl):
    live = sorted(set(tbl[:2].ravel()) - {0})
    for kind, first in (("local", 0), ("global", 1)):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tpool[name][first::2][:, live].numpy(),
                _np(jpool[kind][name])[:, live], **TOL)


@pytest.mark.parametrize("attn", ["gather", "fused"])
def test_paged_decode_matches_reference(attn):
    """Rows at 36 and 30 (one past the window, one inside it), four ticks:
    the local layers read their window through the table.  ``fused`` is
    the kernel's plain route here (CPU tensors)."""
    jc, params, tc, model = pair(GEMMA)
    tbl, jpool, tpool = _pools()
    jpool = jax.tree.map(jnp.asarray, jpool)
    pos = np.array([36, 30, 0], np.int32)
    tok = np.array([3, 77, 0], np.int32)
    for _ in range(4):
        lj, jpool = _jdecode(params, jc, jpool, jnp.asarray(tok),
                             jnp.asarray(pos), jnp.asarray(tbl),
                             attn_impl=attn)
        lt, tpool = decode_step(model, tc, tpool, torch.tensor(tok).long(),
                                torch.tensor(pos), torch.tensor(tbl),
                                attn_impl=attn)
        np.testing.assert_allclose(lt[:2].numpy(), _np(lj)[:2], **TOL)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        tok[2] = 0
        np.testing.assert_array_equal(tok[:2], lt[:2].argmax(-1).numpy())
        pos[:2] += 1
    _same_pools(tpool, jpool, tbl)


@pytest.mark.parametrize("attn", ["gather", "fused"])
def test_verify_step_matches_reference_and_sequential_decode(attn):
    """A span of 4 at positions 36.. and 30.. (row 1 overwrites its last
    prompt positions): the logits equal the reference's verify within
    1e-4, and the port's own 4 decode steps within tolerance with equal
    greedy tokens (the reference's bitwise gemma2 check is red, so the
    port is not held to bits here)."""
    jc, params, tc, model = pair(GEMMA)
    tbl, jpool, pools = _pools()
    s = 4
    pos = np.array([36, 30, 0], np.int32)
    span = _tokens(7, 3, s, jc.vocab).astype(np.int32)
    span[2] = 0
    lj, jpool = _jverify(params, jc, jax.tree.map(jnp.asarray, jpool),
                         jnp.asarray(span), jnp.asarray(pos),
                         jnp.asarray(tbl), attn_impl=attn)
    tpool = {n: p.clone() for n, p in pools.items()}
    lt, tpool = verify_step(model, tc, tpool, torch.tensor(span).long(),
                            torch.tensor(pos), torch.tensor(tbl),
                            attn_impl=attn)
    assert lt.shape == (3, s, tc.vocab) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt[:2].numpy(), _np(lj)[:2], **TOL)
    np.testing.assert_array_equal(lt[:2].argmax(-1).numpy(),
                                  _np(lj)[:2].argmax(-1))
    _same_pools(tpool, jpool, tbl)
    seq = {n: p.clone() for n, p in pools.items()}
    for i in range(s):
        ld, seq = decode_step(model, tc, seq, torch.tensor(span[:, i]).long(),
                              torch.tensor(pos + i), torch.tensor(tbl),
                              attn_impl=attn)
        np.testing.assert_allclose(lt[:2, i].numpy(), ld[:2].numpy(), **TOL)
        np.testing.assert_array_equal(lt[:2, i].argmax(-1).numpy(),
                                      ld[:2].argmax(-1).numpy())


def test_skip_draft_is_refused_and_rerank_walks_the_pairs():
    from repro_torch.models import convert_to_compressed, make_draft
    import dataclasses
    jc, params, tc, model = pair(GEMMA)
    with pytest.raises(ValueError, match="plain stacked"):
        make_draft(model, tc, kind="skip")
    ccfg = tc.replace(sparsity=dataclasses.replace(tc.sparsity,
                                                   mode="compressed"))
    cmodel = convert_to_compressed(model, tc)
    draft, dcfg, idx = make_draft(cmodel, ccfg, kind="rerank")
    assert idx is None and dcfg.sparsity.n == 1
    for blk, dblk in zip(cmodel.blocks(), draft.blocks()):
        assert dblk.pn1.scale is blk.pn1.scale
        assert dblk.pn2.scale is blk.pn2.scale
        assert dblk.attn.wq.w_vals.shape[-1] * 2 == \
            blk.attn.wq.w_vals.shape[-1]
