"""Port parity for the SSM family (falcon-mamba-7b) and the hybrid family
(zamba2-7b, also at 5 layers: 2 groups and a tail) as models:
``forward`` / ``loss_fn`` / ``prefill`` / slotted ``decode_step``,
``init_caches`` (the reference's layouts), ``seed_decode_caches``, paged
``decode_step`` (state rows slot-indexed, the shared block's K/V through
the table) against slotted, ``param_count``, ``weight_stream_bytes``
(the shared block counted once) and ``make_draft`` / ``verify_step``'s
refusals, each against the reference on the smoke configs (the
reference's jax.random weights carried over through repro_torch.convert,
inputs drawn with numpy).  Tolerance 1e-4 in f32."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_caches as jinit_caches  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models import make_draft as jdraft  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import weight_stream_bytes as jstream  # noqa: E402
from repro.models.config import param_count as jparams  # noqa: E402
from repro.serve.cache import seed_decode_caches as jseed  # noqa: E402
from _torch_engines import one_thread, pair  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.layers import SparseLinear  # noqa: E402
from repro_torch.models import (decode_step, forward, init_caches,  # noqa: E402
                                loss_fn, make_draft, prefill, verify_step,
                                weight_stream_bytes)
from repro_torch.models.config import param_count  # noqa: E402
from repro_torch.serve import BlockPool, seed_decode_caches  # noqa: E402

FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-7b"
ARCHS = [FALCON, ZAMBA]
TOL = dict(rtol=1e-4, atol=1e-4)
_jforward = jax.jit(jforward, static_argnums=(1,))
_jprefill = jax.jit(jprefill, static_argnums=(1,))
_jdecode = jax.jit(jdecode, static_argnums=(1,))
_jloss = jax.jit(jloss, static_argnums=(1,))
_TAIL = {}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.float().numpy()


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _tail_pair():
    """zamba2 at 5 layers: 2 groups of 2 + a tail of 1 (the smoke config
    has no tail)."""
    if not _TAIL:
        jc = jget(ZAMBA, smoke=True).replace(n_layers=5)
        tc = tget(ZAMBA, smoke=True).replace(n_layers=5)
        params = jax.jit(lambda k: jinit(k, jc)[0])(jax.random.PRNGKey(2))
        _TAIL["v"] = (jc, params, tc, convert.from_reference_params(
            jax.tree.map(np.asarray, params), tc, device="cpu"))
    return _TAIL["v"]


def _models(arch):
    return _tail_pair() if arch == "zamba2-tail" else pair(arch)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("arch", ARCHS + ["zamba2-tail"])
def test_forward_loss_prefill_and_slotted_decode_match_reference(arch):
    jc, params, tc, model = _models(arch)
    toks = _tokens(7, 2, 24, jc.vocab)
    labels = _tokens(8, 2, 24, jc.vocab)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    tol = TOL
    jl, _ = _jforward(params, jc, batch)
    tl, aux = forward(model, tc, tbatch)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
    assert float(aux) == 0.0
    jtot, jparts = _jloss(params, jc, batch)
    ttot, tparts = loss_fn(model, tc, tbatch)
    np.testing.assert_allclose(float(ttot), float(jtot), **tol)
    np.testing.assert_allclose(float(tparts["loss"]), float(jparts["loss"]),
                               **tol)

    p = 20
    jlog, jpf = _jprefill(params, jc, {"tokens": jnp.asarray(toks[:, :p])})
    tlog, tpf = prefill(model, tc, {"tokens": torch.tensor(toks[:, :p])})
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **tol)
    jleaves, jdef = jax.tree_util.tree_flatten(jpf)
    tleaves, tdef = jax.tree_util.tree_flatten(tpf)
    assert tdef == jdef
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(_t(a), _np(b), **tol)

    # the reference's slotted caches and seeding (the prompt is inside the
    # smoke window of 32, where its ring seeding is right)
    max_len = 28
    jcache = jseed(jc, jinit_caches(jc, 2, max_len)[0], jpf)
    tcache = seed_decode_caches(tc, init_caches(tc, 2, max_len, device="cpu"),
                                tpf)
    for a, b in zip(jax.tree_util.tree_leaves(tcache),
                    jax.tree_util.tree_leaves(jcache)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_t(a), _np(b), **tol)
    for i in range(p, 24):
        jlog, jcache = _jdecode(params, jc, jcache, jnp.asarray(toks[:, i]),
                                jnp.int32(i))
        tlog, _ = decode_step(model, tc, tcache, torch.tensor(toks[:, i]),
                              torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), **tol,
                                   err_msg=f"decode at {i}")
        np.testing.assert_allclose(tlog.numpy(), tl[:, i].numpy(), **tol)


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-tail"])
def test_init_caches_layout_equals_reference(arch):
    jc, _, tc, _ = _models(arch)
    for ring in (True, False):
        tcache = init_caches(tc, 3, 40, device="cpu", ring=ring)
        jcache, _ = jinit_caches(jc if ring else jc.replace(window=None),
                                 3, 40)
        tleaves, tdef = jax.tree_util.tree_flatten(tcache)
        jleaves, jdef = jax.tree_util.tree_flatten(jcache)
        assert tdef == jdef
        for a, b in zip(tleaves, jleaves):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
    if tc.family == "hybrid":   # the shared block's rings keep the window
        assert tcache["attn"]["k"].shape[2] == 40
        assert init_caches(tc, 1, 40, device="cpu")["attn"]["k"].shape[2] \
            == tc.window


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-tail"])
def test_seeded_state_does_not_alias_the_prefill(arch):
    """Decode writes the state in place: a decode on the seeded caches
    leaves the prefill's state as it was, so it can seed another cache
    (the card's check seeds the slotted caches and the paged pool from
    one prefill)."""
    _, _, tc, model = _models(arch)
    toks = torch.tensor(_tokens(12, 1, 9, tc.vocab))
    _, pf = prefill(model, tc, {"tokens": toks[:, :8]})
    before = [t.clone() for t in jax.tree_util.tree_leaves(pf)]
    seeded = seed_decode_caches(tc, init_caches(tc, 1, 12, device="cpu"), pf)
    decode_step(model, tc, seeded, toks[:, 8],
                torch.tensor([8], dtype=torch.int32))
    for a, b in zip(jax.tree_util.tree_leaves(pf), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-tail"])
def test_paged_decode_equals_slotted(arch):
    """The paged pool (state rows slot-indexed, the shared block's K/V
    through the table; fused kernel's plain route and gather read) decodes
    as the slotted caches do, from one prefill."""
    _, _, tc, model = _models(arch)
    toks = torch.tensor(_tokens(9, 1, 16, tc.vocab))
    _, pf = prefill(model, tc, {"tokens": toks[:, :12]})
    slotted = seed_decode_caches(tc, init_caches(tc, 1, 24, device="cpu"),
                                 pf)
    pools = {}
    for impl in ("fused", "gather"):
        pool = BlockPool(tc, 3, 24, 4, device="cpu")
        pool.alloc(2, pool.blocks_for(16))
        pool.seed(2, pf, 12)
        pools[impl] = pool
        assert len(pool.state) == (2 if tc.family == "ssm" else
                                   2 * (1 + ("tail" in pool.caches)))
        assert len(pool.paged) == (0 if tc.family == "ssm" else 2)
    for i in range(12, 16):
        want, _ = decode_step(model, tc, slotted, toks[:, i],
                              torch.tensor([i], dtype=torch.int32))
        for impl, pool in pools.items():
            tbl = pool.device_table()
            got, _ = decode_step(model, tc, pool.caches,
                                 torch.tensor([0, 0, int(toks[0, i])]),
                                 torch.tensor([0, 0, i], dtype=torch.int32),
                                 tbl, attn_impl=impl)
            torch.testing.assert_close(got[2:], want, **TOL)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_weight_stream_equal_reference(arch, compressed):
    jc, params, tc, model = pair(arch, compressed)
    for smoke in (True, False):
        assert param_count(tget(arch, smoke=smoke)) == \
            jparams(jget(arch, smoke=smoke))
    js, ts = jstream(params, jc), weight_stream_bytes(model, tc)
    for k in ("dense_bytes", "stream_bytes", "ratio"):
        assert ts[k] == pytest.approx(js[k], rel=1e-12), k
    if arch == ZAMBA:          # the shared block is counted once
        shared = sum(1 for _ in model.shared.modules()
                     if isinstance(_, SparseLinear))
        mamba = tc.n_layers * 2
        assert ts["compressed_linears"] + ts["dense_linears"] == \
            mamba + shared


@pytest.mark.parametrize("arch", ARCHS)
def test_draft_and_verify_refusals_match_reference(arch):
    """``make_draft(kind="skip")`` keeps every other Mamba1 block with the
    reference's cache index, and raises for the hybrid as the reference
    does; ``verify_step`` raises for both (recurrent state cannot score a
    span and roll back)."""
    jc, params, tc, model = pair(arch, compressed=True)
    if arch == ZAMBA:
        with pytest.raises(ValueError, match="skip draft"):
            jdraft(params, jc, kind="skip")
        with pytest.raises(ValueError, match="skip draft"):
            make_draft(model, tc, kind="skip")
    else:
        _, jdc, jidx = jdraft(params, jc, kind="skip")
        draft, tdc, tidx = make_draft(model, tc, kind="skip")
        np.testing.assert_array_equal(tidx, np.asarray(jidx))
        assert tdc.n_layers == jdc.n_layers == len(draft.layers)
        assert all(a is model.layers[i]
                   for a, i in zip(draft.layers, tidx))
        # rerank: a view over the same model, n 1
        rdraft, rdc, ridx = make_draft(model, tc, kind="rerank")
        assert ridx is None and rdc.sparsity.n == 1
        assert rdraft.embed.emb is model.embed.emb
    caches = init_caches(tc, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="block table"):
        verify_step(model, tc, caches, torch.zeros(1, 2, dtype=torch.long),
                    torch.zeros(1, dtype=torch.int32),
                    torch.zeros(1, 2, dtype=torch.int32))


