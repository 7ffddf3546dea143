"""Port parity: the plain versions of the three ported kernels against the
reference Pallas kernels run in interpret mode (as tests/test_kernels.py and
tests/test_paged_attn.py run them), plus the sparse-matmul execution policy
and the traffic formulas.  On the CPU every wrapper takes its plain version
(no launch is counted); the kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances are the reference's own: 1e-4 (f32) and 2e-2 (bf16) for the
matmuls (tests/test_kernels.py), 2e-4 for attention
(tests/test_paged_attn.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.sparsity import compress as jcompress  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    paged_decode_traffic as j_paged_traffic  # noqa: E402
from repro.kernels.flash_attention import paged_gqa_decode as j_paged  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.sparse_matmul import (SparsityConfig, nm_matmul,  # noqa: E402
                                            select_impl)
from repro_torch.core.sparsity import NMSparse  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

NM = [(1, 4), (2, 4), (1, 2), (2, 8)]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _operands(seed, b, o, k, n, m, dtype):
    """Same numpy inputs on both sides: x [b, k], compressed W [o, k]."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((o, k)), _jdt(dtype))
    x = jnp.asarray(rng.standard_normal((b, k)), _jdt(dtype))
    sp = jcompress(w, n, m)
    t = [to_torch(np.asarray(a), "cpu") for a in (x, sp.values, sp.indices)]
    return (x, sp.values, sp.indices), t


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("nm", NM)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 5, 8])
def test_nm_spmv_plain_matches_reference_kernel(nm, dtype, b):
    n, m = nm
    (x, v, i), (xt, vt, it) = _operands(10 + b, b, 96, 128, n, m, dtype)
    want = kops.nm_spmv(x, v, i, n, m, interpret=True)
    got = tops.nm_spmv(xt, vt, it, n, m)
    assert got.dtype == xt.dtype and got.shape == (b, 96)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("nm", NM)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 64, 128), (13, 80, 136)])
def test_nm_xwt_plain_matches_reference_kernel(nm, dtype, shape):
    n, m = nm
    s, o, k = shape
    k = -(-k // m) * m
    (x, v, i), (xt, vt, it) = _operands(20 + s, s, o, k, n, m, dtype)
    want = kops.nm_xwt(x, v, i, n, m, interpret=True)
    got = tops.nm_xwt(xt, vt, it, n, m)
    assert got.dtype == xt.dtype and got.shape == (s, o)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("nm", [(2, 4), (1, 2)])
def test_ref_oracles_match_reference_oracles(nm):
    n, m = nm
    (x, v, i), (xt, vt, it) = _operands(30, 6, 64, 128, n, m, "float32")
    for jf, tf in ((jref.nm_xwt_ref, tref.nm_xwt_ref),
                   (jref.nm_spmv_ref, tref.nm_spmv_ref)):
        np.testing.assert_allclose(tf(xt, vt, it, n, m).numpy(),
                                   np.asarray(jf(x, v, i, n, m)),
                                   rtol=1e-4, atol=1e-4)
    bmat = np.random.default_rng(31).standard_normal((128, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tref.nm_spmm_ref(vt, it, torch.tensor(bmat), n, m).numpy(),
        np.asarray(jref.nm_spmm_ref(v, i, jnp.asarray(bmat), n, m)),
        rtol=1e-4, atol=1e-4)


def test_wrappers_take_any_leading_shape():
    (_, _, _), (xt, vt, it) = _operands(40, 6, 32, 64, 2, 4, "float32")
    x3 = xt.reshape(3, 2, 64)
    np.testing.assert_allclose(tops.nm_xwt(x3, vt, it, 2, 4).reshape(6, 32),
                               tops.nm_xwt(xt, vt, it, 2, 4), rtol=0, atol=0)
    x3 = xt.reshape(6, 1, 64)
    np.testing.assert_allclose(tops.nm_spmv(x3, vt, it, 2, 4).reshape(6, 32),
                               tops.nm_spmv(xt, vt, it, 2, 4), rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not match"):
        tops.nm_spmv(xt[:, :60], vt, it, 2, 4)


def test_cpu_wrappers_launch_nothing():
    tkernels.reset_launch_counts()
    (_, _, _), (xt, vt, it) = _operands(41, 2, 32, 64, 2, 4, "float32")
    tops.nm_spmv(xt, vt, it, 2, 4)
    tops.nm_xwt(xt, vt, it, 2, 4)
    tfa.paged_mla_decode(torch.zeros(1, 2, 8), torch.zeros(1, 2, 4),
                         torch.zeros(2, 4, 8), torch.zeros(2, 4, 4),
                         torch.ones(1, 1, dtype=torch.int32),
                         torch.ones(1, dtype=torch.int32), scale=0.5)
    counts = [k.launches for k in tkernels.all_kernels()]
    assert len(counts) == 4 and counts == [0] * 4


# ------------------------------------------------------------- the policy

def test_select_impl_policy_on_cpu():
    cfg = SparsityConfig(mode="compressed")
    assert select_impl(cfg, torch.zeros(4, 1, 8)) == "plain"
    assert select_impl(cfg, torch.zeros(1, 16, 8)) == "plain"
    pinned = SparsityConfig(mode="compressed", impl="ref")
    assert select_impl(pinned, torch.zeros(4, 1, 8)) == "ref"


def test_nm_matmul_impls_agree():
    (x, v, i), (xt, vt, it) = _operands(42, 8, 64, 128, 2, 4, "float32")
    sp = NMSparse(vt, it, 2, 4, (64, 128))
    want = np.asarray(jref.nm_xwt_ref(x, v, i, 2, 4))
    for impl in ("auto", "ref", "plain", "xwt", "spmv"):
        np.testing.assert_allclose(nm_matmul(xt, sp, impl=impl).numpy(), want,
                                   rtol=1e-4, atol=1e-4, err_msg=impl)
    with pytest.raises(ValueError, match="ring"):
        nm_matmul(xt, sp, impl="ring")


@pytest.mark.parametrize("bsz,o,k", [(1, 2048, 2048), (8, 512, 2048),
                                     (130, 96, 520)])
def test_traffic_formulas_match_reference(bsz, o, k):
    assert tops.traffic_spmv(bsz, o, k, 2, 4) == kops.traffic_spmv(
        bsz, o, k, 2, 4)
    assert tops.traffic_mm(bsz, o, k, 2, 4) == kops.traffic_mm(bsz, o, k, 2, 4)
    assert tfa.paged_decode_traffic(4, 8, 16, [1, 17, 64, 128], 64, 64) \
        == j_paged_traffic(4, 8, 16, [1, 17, 64, 128], 64, 64)


# ------------------------------------------------------ paged GQA decode

_LENS = (1, 7, 8, 9, 16, 31, 32)


def _paged_case(bs, dtype, seed):
    """Ragged kv_len over every block-boundary edge, a shuffled table of
    owned blocks, and a hot trash block 0 the mask must zero out."""
    b, kvh, g, d = len(_LENS), 2, 4, 32
    tw = -(-max(_LENS) // bs)
    n_blocks = b * tw + 1
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, n_blocks))
    tbl = np.zeros((b, tw), np.int32)
    for r, ln in enumerate(_LENS):
        own = -(-ln // bs)
        tbl[r, :own] = perm[r * tw:r * tw + own]
    kp = rng.standard_normal((n_blocks, bs, kvh, d))
    vp = rng.standard_normal((n_blocks, bs, kvh, d))
    kp[0] = vp[0] = 1e4
    q = rng.standard_normal((b, kvh, g, d))
    arrs = [jnp.asarray(a, _jdt(dtype)) for a in (q, kp, vp)]
    arrs += [jnp.asarray(tbl), jnp.asarray(np.asarray(_LENS, np.int32))]
    return arrs, [to_torch(np.asarray(a), "cpu") for a in arrs]


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [dict(), dict(window=6), dict(cap=20.0),
                                  dict(window=9, cap=20.0)])
def test_paged_gqa_decode_plain_matches_reference_kernel(bs, dtype, case):
    (jargs, targs) = _paged_case(bs, dtype, seed=bs)
    scale = 32 ** -0.5
    want = jax.jit(lambda *a: j_paged(*a, scale=scale, interpret=True,
                                      **case))(*jargs)
    got = tfa.paged_gqa_decode(*targs, scale=scale, **case)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
