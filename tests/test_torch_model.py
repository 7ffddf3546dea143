"""Port parity: the dense model (repro_torch.models) against the reference
on the llama3.2-1b smoke config (f32), with the reference's
jax.random-initialized weights carried over through repro_torch.convert.
prefill and decode_step logits must agree within 1e-4, for dense and for
compressed weights, on both paged decode reads (fused, gather)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import convert_to_compressed as jconvert  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import weight_stream_bytes as jstream  # noqa: E402
from repro.models.common import lm_head_apply as jhead  # noqa: E402
from _torch_engines import one_thread  # noqa: E402,F401
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import from_reference_params, to_torch  # noqa: E402
from repro_torch.models import (convert_to_compressed, decode_step,  # noqa: E402
                                init_model, param_count, prefill,
                                weight_stream_bytes)
from repro_torch.models.common import Embedding, lm_head_apply  # noqa: E402
from repro_torch.models.config import param_count as tparam  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
_CACHE = {}


def _pair(compressed: bool):
    """(reference cfg, reference params, port cfg, port model), smoke size."""
    if compressed not in _CACHE:
        jc, tc = jget("llama3.2-1b", smoke=True), tget("llama3.2-1b", smoke=True)
        params, _ = jinit(jax.random.PRNGKey(0), jc)
        if compressed:
            jc = jc.replace(sparsity=dataclasses.replace(
                jc.sparsity, mode="compressed"))
            tc = tc.replace(sparsity=dataclasses.replace(
                tc.sparsity, mode="compressed"))
            params = jconvert(params, jc)
        model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                      device="cpu")
        _CACHE[compressed] = (jc, params, tc, model)
    return _CACHE[compressed]


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("logit_pos", [None, 5])
def test_prefill_logits_and_caches_match(compressed, logit_pos):
    jc, params, tc, model = _pair(compressed)
    toks = _tokens(1, 2, 12, jc.vocab)
    lj, cj = jprefill(params, jc, {"tokens": jnp.asarray(toks)},
                      logit_pos=None if logit_pos is None
                      else jnp.asarray(logit_pos))
    lt, ct = prefill(model, tc, {"tokens": torch.tensor(toks).long()},
                     logit_pos=logit_pos)
    assert lt.dtype == torch.float32 and lt.shape == (2, jc.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   **TOL)


def _paged_from_prefill(cj, tbl, n_blocks, bs, seeded):
    """Both sides' pools, seeded with the same prefill K/V through tbl."""
    pools = {}
    for name in ("k", "v"):
        c = np.asarray(cj[name])                       # [L, B, S, kv, hd]
        pool = np.zeros((c.shape[0], n_blocks, bs) + c.shape[3:], c.dtype)
        for b in range(c.shape[1]):
            for p in range(seeded):
                pool[:, tbl[b, p // bs], p % bs] = c[:, b, p]
        pools[name] = pool
    return pools


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("attn", ["fused", "gather"])
def test_decode_steps_match(compressed, attn):
    """Three decode ticks over a shuffled paged table, ragged positions and
    one idle (trash-table) row: logits and the updated pools agree."""
    jc, params, tc, model = _pair(compressed)
    bs, seeded = 4, 9
    toks = _tokens(2, 3, seeded, jc.vocab)
    _, cj = jprefill(params, jc, {"tokens": jnp.asarray(toks)})
    tbl = np.zeros((3, 4), np.int32)
    tbl[0, :3] = [5, 1, 9]
    tbl[1, :3] = [2, 7, 4]                             # row 2 idle: all trash
    pools = _paged_from_prefill(cj, tbl, 10, bs, seeded)
    jpool = {k: jnp.asarray(v) for k, v in pools.items()}
    tpool = {k: torch.tensor(v) for k, v in pools.items()}
    pos = np.array([seeded, seeded - 2, 0], np.int32)
    tok = np.array([3, 77, 0], np.int32)
    for _ in range(3):
        lj, jpool = jdecode(params, jc, jpool, jnp.asarray(tok),
                            jnp.asarray(pos), jnp.asarray(tbl), attn_impl=attn)
        lt, tpool = decode_step(model, tc, tpool, torch.tensor(tok).long(),
                                torch.tensor(pos), torch.tensor(tbl),
                                attn_impl=attn)
        np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2], **TOL)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        tok[2] = 0
        np.testing.assert_array_equal(tok[:2], lt[:2].argmax(-1).numpy())
        pos[:2] += 1
    for name in ("k", "v"):
        live = sorted(set(tbl[:2].ravel()) - {0})
        np.testing.assert_allclose(tpool[name][:, live].numpy(),
                                   np.asarray(jpool[name])[:, live], **TOL)


def test_convert_to_compressed_matches_reference():
    jc, params, tc, model = _pair(False)
    jcc = jc.replace(sparsity=dataclasses.replace(jc.sparsity,
                                                  mode="compressed"))
    want = jconvert(params, jcc)
    got = convert_to_compressed(model, tc)
    lin, ref = got.layers[1].mlp.wd, want["layers"]["mlp"]["wd"]
    np.testing.assert_array_equal(lin.w_idx.numpy(), np.asarray(ref["w_idx"])[1])
    np.testing.assert_array_equal(lin.w_vals.numpy(),
                                  np.asarray(ref["w_vals"])[1])
    assert not model.layers[1].mlp.wd.compressed      # original untouched
    assert got.embed.emb is model.embed.emb           # non-linears shared
    ws, wj = weight_stream_bytes(got, tc), jstream(want, jcc)
    for key in ("dense_bytes", "stream_bytes", "ratio"):
        assert ws[key] == wj[key], key
    # the reference counts a stacked [L, ...] leaf once, the port each layer
    for key in ("compressed_linears", "dense_linears"):
        assert ws[key] == wj[key] * tc.n_layers, key


def test_lm_head_keeps_f32_logits_for_bf16_inputs():
    rng = np.random.default_rng(5)
    emb = jnp.asarray(rng.standard_normal((64, 32)), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((3, 32)), jnp.bfloat16)
    want = np.asarray(jhead({"emb": emb}, x))
    got = lm_head_apply(Embedding(to_torch(np.asarray(emb), "cpu")),
                        to_torch(np.asarray(x), "cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_init_model_shapes_and_param_count():
    cfg = tget("llama3.2-1b", smoke=True)
    model = init_model(cfg, seed=0, device="cpu")
    n = sum(t.numel() for t in model.state_dict().values()
            if t.dtype.is_floating_point)
    n -= sum(p.scale.numel() for p in model.modules() if hasattr(p, "scale"))
    assert n == tparam(cfg) == param_count(cfg)
    again = init_model(cfg, seed=0, device="cpu")
    assert torch.equal(model.layers[0].attn.wq.w, again.layers[0].attn.wq.w)
    full = tget("llama3.2-1b")
    from repro.models.config import param_count as jparam
    assert param_count(full) == jparam(jget("llama3.2-1b"))


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        init_model(tget("llama3.2-1b", smoke=True))
