"""Port parity for the vlm family (qwen2-vl-7b: dense GQA blocks with qkv
biases over precomputed embeddings) as a model: a block, ``forward`` /
``loss_fn`` and ``prefill`` (at ``logit_pos``) on ``embeds`` inputs and on
tokens, slotted and paged ``decode_step`` (the fused kernel's plain route
and the gather read), ``verify_step``, both drafts, ``convert_to_compressed``
and ``weight_stream_bytes``, each against the reference on the smoke
config (the reference's jax.random weights, its qkv biases drawn nonzero,
carried over through repro_torch.convert; inputs drawn with numpy).
Tolerances: 1e-4 in f32, 2e-2 in bf16."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_caches as jinit_caches  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models import make_draft as jdraft  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import verify_step as jverify  # noqa: E402
from repro.models import weight_stream_bytes as jstream  # noqa: E402
from repro.serve.cache import seed_decode_caches as jseed  # noqa: E402
from _torch_engines import one_thread, pair  # noqa: E402,F401
from repro_torch.core.layers import SparseLinear  # noqa: E402
from repro_torch.models import (DenseLM, convert_to_compressed,  # noqa: E402
                                decode_step, forward, init_caches, loss_fn,
                                make_draft, prefill, verify_step,
                                weight_stream_bytes)
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.serve import BlockPool, seed_decode_caches  # noqa: E402

QWEN = "qwen2-vl-7b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
F32 = TOL["float32"]
_jforward = jax.jit(jforward, static_argnums=(1,))
_jprefill = jax.jit(jprefill, static_argnums=(1,))
_jdecode = jax.jit(jdecode, static_argnums=(1,), static_argnames="attn_impl")
_jloss = jax.jit(jloss, static_argnums=(1,))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.float().numpy()


def _embeds(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.standard_normal((b, s, cfg.d_model))
            .astype(np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


def test_config_and_biases_carried_over():
    jc, params, tc, model = pair(QWEN)
    assert isinstance(model, DenseLM) and tc.input_mode == "embeds"
    assert tc.qkv_bias and not tc.tie_embeddings
    for i, blk in enumerate(model.layers):
        for name in ("wq", "wk", "wv"):
            lin = getattr(blk.attn, name)
            assert float(lin.b.abs().max()) > 0.1
            np.testing.assert_array_equal(
                lin.b.numpy(), _np(params["layers"]["attn"][name]["b"][i]))
        assert not blk.attn.wo.has("b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_and_embeds_input_match_reference(dtype):
    """Block 2 on embeddings (RoPE at theta 1e6, GQA, the biases), and the
    embeddings cast to the model's dtype as the first residual.  (Whole
    bf16 models differ from the reference by up to ~0.04 in the logits, as
    the dense family's do; ``forward`` is checked in f32.)"""
    jc, params, tc, model = pair(QWEN, dtype=dtype)
    batch = _embeds(jc, 2, 9, seed=1)
    jb, tb = _both(batch)
    jx = jtransformer._embed_in(params, jc, jb)
    tx = ttransformer._embed_in(model, tc, tb)
    assert tx.dtype == tc.tdtype()
    np.testing.assert_array_equal(_t(tx), _np(jx))
    pos = np.broadcast_to(np.arange(9)[None], (2, 9))
    jlayer = jax.tree.map(lambda a: a[2], params["layers"])
    jy, jkv = jtransformer._dense_block_apply(jlayer, jx, jc,
                                              positions=jnp.asarray(pos),
                                              return_kv=True)
    ty, tkv = ttransformer._dense_block_apply(model.layers[2], tx, tc,
                                              positions=torch.tensor(pos),
                                              return_kv=True)
    np.testing.assert_allclose(_t(ty), _np(jy), **TOL[dtype])
    np.testing.assert_allclose(_t(tkv["k"]), _np(jkv["k"]), **TOL[dtype])


def test_forward_loss_and_prefill_match_reference():
    jc, params, tc, model = pair(QWEN)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, jc.vocab, (2, 11))
    for batch in (_embeds(jc, 2, 11, seed=3),
                  {"tokens": rng.integers(0, jc.vocab, (2, 11))}):
        jb, tb = _both(batch)
        lj, _ = _jforward(params, jc, jb)
        lt, aux = forward(model, tc, tb)
        np.testing.assert_allclose(_t(lt), _np(lj), **F32)
        assert float(aux) == 0.0
        vj, _ = _jloss(params, jc, dict(jb, labels=jnp.asarray(labels)))
        vt, _ = loss_fn(model, tc, dict(tb, labels=torch.tensor(labels)))
        np.testing.assert_allclose(float(vt), float(vj), **F32)
        for lp in (None, 4):
            pj, cj = _jprefill(params, jc, jb, logit_pos=lp)
            pt, ct = prefill(model, tc, tb, logit_pos=lp)
            np.testing.assert_allclose(_t(pt), _np(pj), **F32)
        for name in ("k", "v"):
            np.testing.assert_allclose(_t(ct[name]), _np(cj[name]), **F32)


def test_decode_slotted_paged_and_verify_match_reference():
    """Prefill over embeddings, then token decode on the slotted caches
    against the reference's, on the paged pool (fused plain route, gather)
    against slotted, and a verify span of 3 against 3 decode steps and the
    reference's verify_step."""
    jc, params, tc, model = pair(QWEN)
    jb, tb = _both(_embeds(jc, 2, 9, seed=4))
    _, cj = _jprefill(params, jc, jb)
    _, ct = prefill(model, tc, tb)
    jcache = jseed(jc, jinit_caches(jc, 2, 16)[0], cj)
    tcache = seed_decode_caches(tc, init_caches(tc, 2, 16, device="cpu"), ct)
    toks = np.random.default_rng(5).integers(0, jc.vocab, (2, 3))
    pos = np.array([9, 9], np.int32)
    want = []
    for i in range(3):
        lj, jcache = _jdecode(params, jc, jcache, jnp.asarray(toks[:, i]),
                              jnp.asarray(pos + i))
        lt, _ = decode_step(model, tc, tcache, torch.tensor(toks[:, i]),
                            torch.tensor(pos + i))
        np.testing.assert_allclose(lt.numpy(), _np(lj), **F32)
        want.append(lt)

    def pool():
        p = BlockPool(tc, 2, 16, 4, device="cpu")
        assert not p.state
        for slot in range(2):
            p.alloc(slot, p.blocks_for(12))
            p.seed(slot, {n: t[:, slot:slot + 1] for n, t in ct.items()}, 9)
        return p
    for attn in ("fused", "gather"):
        p = pool()
        for i in range(3):
            lt, _ = decode_step(model, tc, p.caches, torch.tensor(toks[:, i]),
                                torch.tensor(pos + i), p.device_table(),
                                attn_impl=attn)
            np.testing.assert_allclose(lt.numpy(), want[i].numpy(), **F32)
    p = pool()
    jpool = {n: jnp.asarray(_t(t)) for n, t in p.caches.items()}
    tbl = p.device_table()
    lt, _ = verify_step(model, tc, p.caches, torch.tensor(toks),
                        torch.tensor(pos), tbl, attn_impl="fused")
    lj, _ = jax.jit(jverify, static_argnums=(1,))(
        params, jc, jpool, jnp.asarray(toks, jnp.int32), jnp.asarray(pos),
        jnp.asarray(tbl.numpy()))
    np.testing.assert_allclose(lt.numpy(), _np(lj), **F32)
    for i in range(3):
        np.testing.assert_allclose(lt[:, i].numpy(), want[i].numpy(), **F32)


def test_drafts_convert_and_weight_stream_match_reference():
    jc, params, tc, model = pair(QWEN, compressed=True)
    _, _, _, dense = pair(QWEN)
    conv = convert_to_compressed(dense, tc)
    for a, b in zip([m for m in conv.modules() if isinstance(m, SparseLinear)],
                    [m for m in model.modules()
                     if isinstance(m, SparseLinear)]):
        assert a.compressed and torch.equal(a.w_vals, b.w_vals)
        assert torch.equal(a.w_idx, b.w_idx)
        assert a.has("b") == b.has("b")
        if a.has("b"):
            assert torch.equal(a.b, b.b)
    ws, wj = weight_stream_bytes(model, tc), jstream(params, jc)
    for k in ("dense_bytes", "stream_bytes", "ratio"):
        assert ws[k] == wj[k], k
    for kind in ("rerank", "skip"):
        draft, dcfg, idx = make_draft(model, tc, kind)
        jd, jdc, jidx = jdraft(params, jc, kind)
        assert weight_stream_bytes(draft, dcfg)["stream_bytes"] == \
            jstream(jd, jdc)["stream_bytes"], kind
        assert (idx is None) == (jidx is None)
        if idx is not None:
            np.testing.assert_array_equal(idx, jidx)
