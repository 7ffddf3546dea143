"""Port parity for the mixers of the SSM family (falcon-mamba-7b, Mamba1)
and the hybrid family (zamba2-7b, Mamba2): ``Mamba1`` / ``Mamba2`` in
prefill, ``return_state`` and decode against ``mamba1_apply`` /
``mamba2_apply`` (several S, some not a multiple of the chunk), in f32
and bf16; the chunked scan against the plain recurrence; and bf16 models
a block deep.  The models' other entry points are in
``tests/test_torch_ssm_model.py``, the engines in
``tests/test_torch_ssm_engine.py``.  The reference's jax.random weights
are carried over through repro_torch.convert, inputs drawn with numpy.

The conv tail of a prompt shorter than K - 1 = 3: the reference slices
the prompt's own positions (a tail of 1 or 2 rows, which no decode cache
takes); the port pads it with the zeros decode would hold, and its decode
after such a prompt is held to the reference's ``forward``.

Tolerances: 1e-4 in f32 and 2e-2 in bf16 (``tests/test_kernels.py``)."""

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
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve.cache import seed_decode_caches as jseed  # noqa: E402
from _torch_engines import one_thread, pair  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import decode_step, init_caches, prefill  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serve import seed_decode_caches  # noqa: E402

FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-7b"
ARCHS = [FALCON, ZAMBA]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
_jforward = jax.jit(jforward, static_argnums=(1,))
_jprefill = jax.jit(jprefill, static_argnums=(1,))
_jdecode = jax.jit(jdecode, static_argnums=(1,))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.float().numpy()


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


# ------------------------------------------------------------------ mixers

def _mixer(arch, dtype):
    """A reference mixer (params, cfg) and the port's, bf16 or f32."""
    jc = jget(arch, smoke=True).replace(dtype=dtype)
    tc = tget(arch, smoke=True).replace(dtype=dtype)
    init = jssm.mamba1_init if jc.mamba_version == 1 else jssm.mamba2_init
    jp, _ = init(jax.random.PRNGKey(3), jc, jc.jdtype())
    tree = {"ln": {"scale": np.ones(jc.d_model, np.float32)},
            "mixer": jax.tree.map(np.asarray, jp)}
    return jc, jp, tc, convert._ssm_block(tree, tc, "cpu").mixer


_JAPPLY = {v: jax.jit(f, static_argnums=(2,), static_argnames="return_state")
           for v, f in ((1, jssm.mamba1_apply), (2, jssm.mamba2_apply))}


def _apply(arch):
    return ((_JAPPLY[1], tssm.mamba1_apply) if arch == FALCON
            else (_JAPPLY[2], tssm.mamba2_apply))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_prefill_state_and_decode_match_reference(arch, dtype):
    """Prefill at S = 5, 16, 21 and 40 (chunk 16: one, a part, ragged
    tails) with ``return_state``, then 3 decode steps from that state."""
    jc, jp, tc, mixer = _mixer(arch, dtype)
    japply, tapply = _apply(arch)
    tol = TOL[dtype]
    rng = np.random.default_rng(4)
    for s in (5, 16, 21, 40):
        x = rng.normal(size=(2, s + 3, jc.d_model)).astype(np.float32)
        jx = jnp.asarray(x, jc.jdtype())
        tx = torch.tensor(x).to(tc.tdtype())
        jy, jst = japply(jp, jx[:, :s], jc, return_state=True)
        ty, tst = tapply(mixer, tx[:, :s], tc, return_state=True)
        np.testing.assert_allclose(_t(ty), _np(jy), **tol, err_msg=f"S {s}")
        for f in ("h", "conv"):
            np.testing.assert_allclose(_t(tst[f]), _np(jst[f]), **tol,
                                       err_msg=f"S {s} {f}")
        # no state asked: none returned, the same output
        assert tapply(mixer, tx[:, :s], tc)[1] is None
        ptrs = {f: t.data_ptr() for f, t in tst.items()}
        for i in range(s, s + 3):
            jy, jst = japply(jp, jx[:, i:i + 1], jc, cache=jst)
            ty, new = tapply(mixer, tx[:, i:i + 1], tc, cache=tst)
            assert new is tst and {f: t.data_ptr() for f, t in
                                   tst.items()} == ptrs   # in place
            np.testing.assert_allclose(_t(ty), _np(jy), **tol,
                                       err_msg=f"S {s} decode {i}")
            for f in ("h", "conv"):
                np.testing.assert_allclose(_t(tst[f]), _np(jst[f]), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompt_conv_tail_is_zero_padded(arch):
    """S = 1, 2 (shorter than K - 1): the port's tail is the prompt's rows
    after K - 1 - S zero rows, the state decode from an empty cache holds,
    and prefill + decode equals decoding every token from zeros."""
    jc, jp, tc, mixer = _mixer(arch, "float32")
    _, tapply = _apply(arch)
    x = torch.tensor(np.random.default_rng(5).normal(
        size=(2, 4, jc.d_model)).astype(np.float32))
    for s in (1, 2):
        _, st = tapply(mixer, x[:, :s], tc, return_state=True)
        xin = tssm.linear_apply(mixer.in_proj, x[:, :s],
                                tc.sparsity)[..., :tc.dinner()]
        want = torch.cat([torch.zeros(2, 3 - s, tc.dinner()), xin], 1)
        torch.testing.assert_close(st["conv"], want)
        zero = {f: torch.zeros_like(t) for f, t in st.items()}
        for i in range(s):
            tapply(mixer, x[:, i:i + 1], tc, cache=zero)
        torch.testing.assert_close(zero["h"], st["h"], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(zero["conv"], st["conv"])
        yp, _ = tapply(mixer, x[:, s:s + 1], tc, cache=st)
        yz, _ = tapply(mixer, x[:, s:s + 1], tc, cache=zero)
        torch.testing.assert_close(yp, yz, rtol=1e-5, atol=1e-5)


def test_mamba1_scan_is_the_recurrence():
    """The chunked log-depth scan equals the plain recurrence, chunk 1
    (no scan levels), a chunk past S and a ragged last chunk alike."""
    rng = np.random.default_rng(6)
    b, s, di, st = 2, 37, 12, 5
    dt = torch.tensor(rng.uniform(0.01, 1.0, (b, s, di)), dtype=torch.float32)
    xs = torch.tensor(rng.normal(size=(b, s, di)), dtype=torch.float32)
    bm = torch.tensor(rng.normal(size=(b, s, st)), dtype=torch.float32)
    cm = torch.tensor(rng.normal(size=(b, s, st)), dtype=torch.float32)
    a = -torch.tensor(rng.uniform(0.5, 4.0, (di, st)), dtype=torch.float32)
    h = torch.zeros(b, di, st)
    want = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * xs[:, t])[..., None] * bm[:, t, None, :]
        want.append(torch.einsum("bds,bs->bd", h, cm[:, t]))
    want = torch.stack(want, 1)
    for chunk in (1, 8, 16, 64):
        y, hl = tssm.mamba1_scan(dt, bm, cm, xs, a, chunk)
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(hl, h, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompt_decode_matches_reference_forward(arch):
    """Prompts of 1 and 2 tokens (shorter than the conv's K - 1) prefill
    on the port and decode 3 tokens: the logits equal the reference's
    ``forward`` on the same tokens."""
    jc, params, tc, model = pair(arch)
    toks = _tokens(10, 1, 5, jc.vocab)
    want, _ = _jforward(params, jc, {"tokens": jnp.asarray(toks)})
    for p in (1, 2):
        _, pf = prefill(model, tc, {"tokens": torch.tensor(toks[:, :p])})
        caches = seed_decode_caches(tc, init_caches(tc, 1, 8, device="cpu"),
                                    pf)
        for i in range(p, 5):
            got, _ = decode_step(model, tc, caches, torch.tensor(toks[:, i]),
                                 torch.tensor(i, dtype=torch.int32))
            np.testing.assert_allclose(got.numpy(), _np(want[:, i]),
                                       **TOL["float32"], err_msg=f"P {p}")


@pytest.mark.parametrize("arch,layers", [(FALCON, 1), (ZAMBA, 2)])
def test_bf16_model_decode_matches_reference(arch, layers):
    """bf16 weights drawn by the reference, one Mamba1 block (falcon) or
    one group of two Mamba2 blocks and the shared block (zamba2): prefill
    + 2 decode steps within 2e-2 of the reference.  (Deeper, the bf16
    roundings of sums taken in other orders compound: 4 zamba2 layers
    differ by up to 0.036; one falcon block agrees to 5e-6, so the
    rounding points are the reference's.)"""
    jc = jget(arch, smoke=True).replace(dtype="bfloat16", n_layers=layers)
    tc = tget(arch, smoke=True).replace(dtype="bfloat16", n_layers=layers)
    params = jax.jit(lambda k: jinit(k, jc)[0])(jax.random.PRNGKey(4))
    model = convert.from_reference_params(jax.tree.map(np.asarray, params),
                                          tc, device="cpu")
    toks = _tokens(11, 2, 10, jc.vocab)
    jlog, jpf = _jprefill(params, jc, {"tokens": jnp.asarray(toks[:, :8])})
    tlog, tpf = prefill(model, tc, {"tokens": torch.tensor(toks[:, :8])})
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL["bfloat16"])
    jcache = jseed(jc, jinit_caches(jc, 2, 12)[0], jpf)
    tcache = seed_decode_caches(tc, init_caches(tc, 2, 12, device="cpu"),
                                tpf)
    for i in (8, 9):
        jlog, jcache = _jdecode(params, jc, jcache, jnp.asarray(toks[:, i]),
                                jnp.int32(i))
        tlog, _ = decode_step(model, tc, tcache, torch.tensor(toks[:, i]),
                              torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(tlog.numpy(), _np(jlog),
                                   **TOL["bfloat16"])
