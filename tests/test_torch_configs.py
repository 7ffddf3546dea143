"""The port's configuration registry against the reference's: every ported
arch (the full config and its ``reduced()`` smoke variant) equals the
reference's field by field on every field of the port's schema,
``param_count`` agrees (total and active), whisper-small's and
qwen2-vl-7b's full-size ``weight_stream_bytes`` agree (the port's model
built abstract, on the meta device, the reference's through
``jax.eval_shape``), and arctic-480b's smoke model
(MoE with a parallel dense-residual MLP, GQA attention) runs ``forward``,
``prefill`` and slotted and paged ``decode_step`` within 1e-4 of the
reference's in f32, with its jax.random weights carried over."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_caches as jinit_caches  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import convert_to_compressed as jconvert  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import weight_stream_bytes as jstream  # noqa: E402
from repro.models.config import param_count as jparam_count  # noqa: E402
from repro.configs import ALL_ARCHS as J_ARCHS  # noqa: E402
from repro.serve.cache import seed_decode_caches as jseed  # noqa: E402
from _torch_engines import one_thread, pair  # noqa: E402,F401
from repro_torch.configs import ALL_ARCHS, get_config as tget  # noqa: E402
from repro_torch.models import (decode_step, forward, init_caches,  # noqa: E402
                                init_model, prefill, weight_stream_bytes)
from repro_torch.models.config import ArchConfig, param_count  # noqa: E402
from repro_torch.serve import seed_decode_caches  # noqa: E402

NEW = ["gemma2-9b", "deepseek-67b", "mistral-large-123b", "arctic-480b",
       "falcon-mamba-7b", "zamba2-7b", "whisper-small", "qwen2-vl-7b"]
ARCTIC = "arctic-480b"
TOL = dict(rtol=1e-4, atol=1e-4)


def test_registry_holds_the_new_archs():
    """Every arch of the reference's registry is the port's; an unknown
    one raises."""
    assert set(NEW) <= set(ALL_ARCHS)
    assert sorted(ALL_ARCHS) == sorted(J_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        tget("whisper-large")


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-7b"])
def test_full_weight_stream_equals_reference(arch):
    """Full width and depth, 2:4 compressed: the bytes a decode step's
    walk over every linear streams (whisper: 286.65 MB, its encoder and
    cross ``wk`` / ``wv`` included, as the reference counts them;
    qwen2-vl: 7.34 GB) and the dense bytes, equal to the reference's."""
    jc, tc = jget(arch), tget(arch)
    jc = jc.replace(sparsity=dataclasses.replace(jc.sparsity,
                                                 mode="compressed"))
    tc = tc.replace(sparsity=dataclasses.replace(tc.sparsity,
                                                 mode="compressed"))
    params = jax.eval_shape(lambda k: jconvert(jinit(k, jc)[0], jc),
                            jax.random.PRNGKey(0))
    want = jstream(params, jc)
    got = weight_stream_bytes(init_model(tc, device="meta"), tc)
    for k in ("dense_bytes", "stream_bytes", "ratio"):
        assert got[k] == want[k], k
    assert got["stream_bytes"] == {"whisper-small": 286654464,
                                   "qwen2-vl-7b": 7340949504}[arch]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_equals_reference_field_by_field(arch, smoke):
    """Every field of either side's ArchConfig and SparsityConfig is on
    both sides with equal values; a field on one side only fails unless
    ``BY_DESIGN`` lists it (empty: the port keeps no field of its own and
    drops none of the reference's)."""
    jc, tc = jget(arch, smoke=smoke), tget(arch, smoke=smoke)

    def fields(obj):
        return {f.name for f in dataclasses.fields(obj)}

    for want, got, where in ((jc, tc, "ArchConfig"),
                             (jc.sparsity, tc.sparsity, "SparsityConfig")):
        one_side = fields(want) ^ fields(got)
        assert one_side <= BY_DESIGN, (arch, where, sorted(one_side))
        for name in sorted(fields(want) & fields(got)):
            if name == "sparsity":
                continue
            assert getattr(got, name) == getattr(want, name), \
                (arch, where, name)


# fields on one side only by design (the reference's or the port's own)
BY_DESIGN: frozenset = frozenset()


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_equals_reference(arch, active_only):
    for smoke in (False, True):
        assert param_count(tget(arch, smoke=smoke), active_only) == \
            jparam_count(jget(arch, smoke=smoke), active_only)


def _np(x):
    return np.asarray(x, np.float32)


def test_arctic_dense_residual_model_matches_reference():
    """Every MoE block carries the dense-residual MLP, and forward /
    prefill / slotted decode / paged decode (fused plain route) agree."""
    jc, params, tc, model = pair(ARCTIC)
    assert tc.dense_residual and all(b.mlp is not None
                                     for b in model.blocks())
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 12))
    lj, aux_j = jax.jit(jforward, static_argnums=(1,))(
        params, jc, {"tokens": jnp.asarray(toks)})
    lt, aux_t = forward(model, tc, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)

    plen = 9
    _, cj = jax.jit(jprefill, static_argnums=(1,))(
        params, jc, {"tokens": jnp.asarray(toks[:, :plen])})
    _, ct = prefill(model, tc, {"tokens": torch.tensor(toks[:, :plen])})
    jcache = jseed(jc, jinit_caches(jc, 2, 16)[0], cj)
    tcache = seed_decode_caches(tc, init_caches(tc, 2, 16, device="cpu"), ct)
    jdec = jax.jit(jdecode, static_argnums=(1,), static_argnames="attn_impl")
    tok = toks[:, plen].astype(np.int32)
    for i in range(3):
        pos = np.int32(plen + i)
        ldj, jcache = jdec(params, jc, jcache, jnp.asarray(tok),
                           jnp.asarray(pos))
        ldt, tcache = decode_step(model, tc, tcache, torch.tensor(tok).long(),
                                  torch.tensor(pos))
        np.testing.assert_allclose(ldt.numpy(), _np(ldj), **TOL)
        tok = np.asarray(jnp.argmax(ldj, -1)).astype(np.int32)
        np.testing.assert_array_equal(tok, ldt.argmax(-1).numpy())

    # the paged pool, seeded from the same prefill through a table
    bs, n_blocks = 4, 12
    tbl = np.array([[3, 7, 1, 9], [2, 5, 11, 4]], np.int32)
    pools = {}
    for name in ("k", "v"):
        c = _np(cj["moe"][name])          # no first dense layer
        pool = np.zeros((c.shape[0], n_blocks, bs) + c.shape[3:], np.float32)
        for row in range(2):
            for p in range(plen):
                pool[:, tbl[row, p // bs], p % bs] = c[:, row, p]
        pools[name] = pool
    jpool = {n: jnp.asarray(p) for n, p in pools.items()}
    tpool = {n: torch.tensor(p) for n, p in pools.items()}
    tok = toks[:, plen].astype(np.int32)
    pos = np.array([plen, plen - 1], np.int32)
    for _ in range(2):
        ldj, jpool = jdec(params, jc, jpool, jnp.asarray(tok),
                          jnp.asarray(pos), jnp.asarray(tbl),
                          attn_impl="fused")
        ldt, tpool = decode_step(model, tc, tpool, torch.tensor(tok).long(),
                                 torch.tensor(pos), torch.tensor(tbl),
                                 attn_impl="fused")
        np.testing.assert_allclose(ldt.numpy(), _np(ldj), **TOL)
        tok = np.asarray(jnp.argmax(ldj, -1)).astype(np.int32)
        pos += 1
