"""Port parity for the audio family (whisper-small, an encoder-decoder) as
a model: ``cross_kv`` / ``cross_attn_apply``, an encoder block,
``forward`` / ``loss_fn``, ``prefill`` (at ``logit_pos``), the cache
layout {"self", "cross_k", "cross_v"} and its seeding, slotted
``decode_step`` (0-d and [B] positions), paged ``decode_step`` (the cross
K/V slot-indexed state of the pool, fused plain route and gather) and
``verify_step``, ``make_draft``, ``convert_to_compressed`` and
``weight_stream_bytes``, each against the reference on the smoke config
(the reference's jax.random weights, its qkv biases drawn nonzero, carried
over through repro_torch.convert; inputs drawn with numpy).  Tolerances:
1e-4 in f32, 2e-2 in bf16."""

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
from repro.models import make_draft as jdraft  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import verify_step as jverify  # noqa: E402
from repro.models import weight_stream_bytes as jstream  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve.cache import seed_decode_caches as jseed  # noqa: E402
from _torch_engines import one_thread, pair  # noqa: E402,F401
from repro_torch.core.layers import SparseLinear  # noqa: E402
from repro_torch.models import (EncDecLM, convert_to_compressed,  # noqa: E402
                                decode_step, forward, init_caches, loss_fn,
                                make_draft, prefill, verify_step,
                                weight_stream_bytes)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.serve import BlockPool, seed_decode_caches  # noqa: E402

WHISPER = "whisper-small"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
_jforward = jax.jit(jforward, static_argnums=(1,))
_jprefill = jax.jit(jprefill, static_argnums=(1,))
_jdecode = jax.jit(jdecode, static_argnums=(1,), static_argnames="attn_impl")
_jloss = jax.jit(jloss, static_argnums=(1,))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.float().numpy()


def _batch(cfg, b, s, seed):
    """Tokens [b, s] and encoder frames [b, enc_seq, d] (numpy)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)),
            "enc_embeds": rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


def test_biases_are_nonzero_and_carried_over():
    jc, params, tc, model = pair(WHISPER)
    assert isinstance(model, EncDecLM)
    assert len(model.enc_layers) == jc.enc_layers == 2
    dec = model.layers[1]
    for lin, ref in ((dec.attn.wq, params["dec_layers"]["self"]["wq"]),
                     (dec.cross.wv, params["dec_layers"]["cross"]["wv"]),
                     (model.enc_layers[0].attn.wk,
                      params["enc_layers"]["attn"]["wk"])):
        i = 1 if lin is not model.enc_layers[0].attn.wk else 0
        assert float(lin.b.abs().max()) > 0.1
        np.testing.assert_array_equal(lin.b.numpy(), _np(ref["b"][i]))
    assert not dec.attn.wo.has("b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_and_blocks_match_reference(dtype):
    """Layer 1's cross K/V projection and cross-attention (3 queries over
    the 64 encoder frames), encoder block 1 and decoder block 1 (causal
    self-attention, cross-attention, MLP), on the same inputs.  (Whole
    bf16 models differ from the reference by up to ~0.04 in the logits,
    as the dense family's do: bf16 roundings of sums taken in other orders
    compound over the blocks and the head; ``forward`` is checked in f32.)"""
    jc, params, tc, model = pair(WHISPER, dtype=dtype)
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, jc.enc_seq, jc.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 3, jc.d_model)).astype(np.float32)
    jdt = jc.jdtype()
    jlayer = jax.tree.map(lambda a: a[1], params["dec_layers"])
    jk, jv = jattn.cross_kv(jlayer["cross"], jnp.asarray(enc, jdt), jc)
    tk, tv = tattn.cross_kv(model.layers[1].cross,
                            torch.tensor(enc).to(tc.tdtype()), tc)
    np.testing.assert_allclose(_t(tk), _np(jk), **TOL[dtype])
    np.testing.assert_allclose(_t(tv), _np(jv), **TOL[dtype])
    assert tk.shape == (2, jc.enc_seq, jc.n_kv, jc.hd())
    jy = jattn.cross_attn_apply(jlayer["cross"], jnp.asarray(x, jdt),
                                (jk, jv), jc)
    ty = tattn.cross_attn_apply(model.layers[1].cross,
                                torch.tensor(x).to(tc.tdtype()), (tk, tv), tc)
    np.testing.assert_allclose(_t(ty), _np(jy), **TOL[dtype])
    jenc = jax.tree.map(lambda a: a[1], params["enc_layers"])
    pos = jnp.arange(jc.enc_seq)[None, :]
    jo = jtransformer._enc_block_apply(jenc, jnp.asarray(enc, jdt), jc, pos)
    to = ttransformer._enc_block_apply(model.enc_layers[1],
                                       torch.tensor(enc).to(tc.tdtype()), tc)
    np.testing.assert_allclose(_t(to), _np(jo), **TOL[dtype])
    xpos = jnp.arange(3)[None, :].repeat(2, 0)
    jx, jkv = jtransformer._dec_block_apply(jlayer, jnp.asarray(x, jdt), jc,
                                            (jk, jv), positions=xpos,
                                            return_kv=True)
    tx, tkv = ttransformer._dec_block_apply(
        model.layers[1], torch.tensor(x).to(tc.tdtype()), tc, (tk, tv),
        positions=torch.tensor(np.asarray(xpos)), return_kv=True)
    np.testing.assert_allclose(_t(tx), _np(jx), **TOL[dtype])
    np.testing.assert_allclose(_t(tkv["k"]), _np(jkv["k"]), **TOL[dtype])


def test_forward_loss_and_prefill_match_reference():
    tol = TOL["float32"]
    jc, params, tc, model = pair(WHISPER)
    batch = _batch(jc, 2, 12, seed=5)
    jb, tb = _both(batch)
    lj, aux_j = _jforward(params, jc, jb)
    lt, aux_t = forward(model, tc, tb)
    np.testing.assert_allclose(_t(lt), _np(lj), **tol)
    assert float(aux_t) == float(aux_j) == 0.0
    labels = np.random.default_rng(6).integers(0, jc.vocab, (2, 12))
    labels[0, :3] = -1
    (vj, _), (vt, _) = (_jloss(params, jc, dict(jb, labels=jnp.asarray(
        labels))), loss_fn(model, tc, dict(tb, labels=torch.tensor(labels))))
    np.testing.assert_allclose(float(vt), float(vj), **tol)
    for lp in (None, 7):
        pj, cj = _jprefill(params, jc, jb, logit_pos=lp)
        pt, ct = prefill(model, tc, tb, logit_pos=lp)
        np.testing.assert_allclose(_t(pt), _np(pj), **tol)
    assert sorted(ct) == sorted(cj) == ["cross_k", "cross_v", "self"]
    for name in ("k", "v"):
        np.testing.assert_allclose(_t(ct["self"][name]),
                                   _np(cj["self"][name]), **tol)
    for name in ("cross_k", "cross_v"):
        assert ct[name].shape == cj[name].shape == (
            jc.n_layers, 2, jc.enc_seq, jc.n_kv, jc.hd())
        np.testing.assert_allclose(_t(ct[name]), _np(cj[name]), **tol)


def _seeded(jc, params, tc, model, batch, max_len):
    jb, tb = _both(batch)
    _, cj = _jprefill(params, jc, jb)
    _, ct = prefill(model, tc, tb)
    return (jseed(jc, jinit_caches(jc, 2, max_len)[0], cj),
            seed_decode_caches(tc, init_caches(tc, 2, max_len, device="cpu"),
                               ct), ct)


def test_caches_seeding_and_slotted_decode_match_reference():
    """The {"self", "cross_k", "cross_v"} layout, seeding (the cross K/V
    copied whole, not aliased), then decode at a 0-d position (the fixed
    batch) and at per-row [B] positions; the cross K/V rows stay as
    prefill wrote them."""
    jc, params, tc, model = pair(WHISPER)
    jcache = jinit_caches(jc, 2, 16)[0]
    tcache = init_caches(tc, 2, 16, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jcache) == {
        k: ({n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict)
            else tuple(v.shape)) for k, v in tcache.items()}
    batch = _batch(jc, 2, 9, seed=7)
    jcache, tcache, ct = _seeded(jc, params, tc, model, batch, 16)
    assert tcache["cross_k"].data_ptr() != ct["cross_k"].data_ptr()
    cross = tcache["cross_k"].clone()
    toks = np.random.default_rng(8).integers(0, jc.vocab, (2, 4))
    for i in range(2):
        pos = np.int32(9 + i)
        lj, jcache = _jdecode(params, jc, jcache, jnp.asarray(toks[:, i]),
                              jnp.asarray(pos))
        lt, _ = decode_step(model, tc, tcache, torch.tensor(toks[:, i]),
                            torch.tensor(pos))
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL["float32"])
    pos = np.array([11, 11], np.int32)
    lj, _ = _jdecode(params, jc, jcache, jnp.asarray(toks[:, 2]),
                     jnp.asarray(pos))
    lt, _ = decode_step(model, tc, tcache, torch.tensor(toks[:, 2]),
                        torch.tensor(pos))
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL["float32"])
    assert torch.equal(tcache["cross_k"], cross)


def _paged(tc, ct, plens, bs=4):
    """A BlockPool of 2 slots seeded from prefill caches ``ct`` at
    ``plens`` positions each."""
    pool = BlockPool(tc, 2, 16, bs, device="cpu")
    for slot, p in enumerate(plens):
        pool.alloc(slot, pool.blocks_for(p + 4))
        single = {"self": {n: t[:, slot:slot + 1] for n, t in
                           ct["self"].items()},
                  "cross_k": ct["cross_k"][:, slot:slot + 1],
                  "cross_v": ct["cross_v"][:, slot:slot + 1]}
        pool.seed(slot, single, p)
    return pool


def test_paged_pool_keeps_cross_kv_as_state_and_decodes_as_slotted():
    """The pool's probe finds cross K/V as slot-indexed state (its length
    is the encoder's, not a position) and pages "self"; paged decode (the
    fused kernel's plain route and the gather read) equals slotted decode,
    and a verify span of 3 equals 3 decode steps and the reference's
    verify_step."""
    jc, params, tc, model = pair(WHISPER)
    batch = _batch(jc, 2, 9, seed=9)
    jslot, tslot, ct = _seeded(jc, params, tc, model, batch, 16)
    pool = _paged(tc, ct, (9, 9))
    assert [tuple(t.shape) for t in pool.state] == [
        (jc.n_layers, 2, jc.enc_seq, jc.n_kv, jc.hd())] * 2
    assert pool.state_axes == [1, 1] and len(pool.paged) == 2
    assert pool.state[0].data_ptr() == pool.caches["cross_k"].data_ptr()
    toks = np.random.default_rng(10).integers(0, jc.vocab, (2, 3))
    pos = np.array([9, 9], np.int32)
    want = []
    for i in range(3):
        lt, _ = decode_step(model, tc, tslot, torch.tensor(toks[:, i]),
                            torch.tensor(pos + i))
        want.append(lt)
    for attn in ("fused", "gather"):
        p = _paged(tc, ct, (9, 9))
        for i in range(3):
            lt, _ = decode_step(model, tc, p.caches, torch.tensor(toks[:, i]),
                                torch.tensor(pos + i), p.device_table(),
                                attn_impl=attn)
            np.testing.assert_allclose(lt.numpy(), want[i].numpy(),
                                       **TOL["float32"])
    p = _paged(tc, ct, (9, 9))
    tbl = p.device_table()
    lt, _ = verify_step(model, tc, p.caches, torch.tensor(toks),
                        torch.tensor(pos), tbl, attn_impl="fused")
    for i in range(3):
        np.testing.assert_allclose(lt[:, i].numpy(), want[i].numpy(),
                                   **TOL["float32"])
    jpool = {"self": {n: jnp.asarray(_t(t)) for n, t in
                      _paged(tc, ct, (9, 9)).caches["self"].items()},
             "cross_k": jnp.asarray(_t(p.caches["cross_k"])),
             "cross_v": jnp.asarray(_t(p.caches["cross_v"]))}
    lj, _ = jax.jit(jverify, static_argnums=(1,))(
        params, jc, jpool, jnp.asarray(toks, jnp.int32), jnp.asarray(pos),
        jnp.asarray(tbl.numpy()))
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL["float32"])


def test_drafts_convert_and_weight_stream_match_reference():
    """Compressed conversion equals the reference's bit for bit (biases
    kept); ``weight_stream_bytes`` counts what the reference's walk counts
    (the encoder and cross ``wk`` / ``wv`` included); the rerank draft
    streams what the reference's does; a skip draft raises in both."""
    jc, params, tc, model = pair(WHISPER, compressed=True)
    _, _, dtc, dense = pair(WHISPER)
    conv = convert_to_compressed(dense, tc)
    lins = [m for m in conv.modules() if isinstance(m, SparseLinear)]
    assert all(m.compressed for m in lins)
    for a, b in zip(lins, [m for m in model.modules()
                           if isinstance(m, SparseLinear)]):
        assert torch.equal(a.w_vals, b.w_vals)
        assert torch.equal(a.w_idx, b.w_idx)
        assert a.has("b") == b.has("b")
        if a.has("b"):
            assert torch.equal(a.b, b.b)
    ws, wj = weight_stream_bytes(model, tc), jstream(params, jc)
    for k in ("dense_bytes", "stream_bytes", "ratio"):
        assert ws[k] == wj[k], k
    assert ws["compressed_linears"] == (jc.enc_layers * 7 + jc.n_layers * 11)
    draft, dcfg, idx = make_draft(model, tc, "rerank")
    jd, jdc, jidx = jdraft(params, jc, "rerank")
    assert idx is None and jidx is None and dcfg.sparsity.n == 1
    assert weight_stream_bytes(draft, dcfg)["stream_bytes"] == \
        jstream(jd, jdc)["stream_bytes"]
    with pytest.raises(ValueError, match="skip draft"):
        jdraft(params, jc, "skip")
    with pytest.raises(ValueError, match="skip draft"):
        make_draft(model, tc, "skip")
