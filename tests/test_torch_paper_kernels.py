"""Port parity for the kernels off the serving path: the paper-orientation
``nm_spmm``, the bit-packed index stream of ``nm_xwt``, the onehot body of
``nm_spmv`` (and the ``spmv_mode`` / ``decode_impl`` policy that reaches
it), and ``flash_attention_kernel``.  The port's plain versions (what every
wrapper runs on the CPU) are held against the reference Pallas kernels in
interpret mode, as tests/test_kernels.py and tests/test_flash_attention.py
run them; the CUDA kernels are held against the same plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances are the reference's own: 1e-4 (f32) and 2e-2 (bf16) for the
matmuls, 2e-4 (f32) and 3e-2 (bf16) for flash attention.  Packed index
words are compared bit for bit."""

import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.sparsity import compress as jcompress  # noqa: E402
from repro.core.sparsity import pack_indices as jpack  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_kernel as j_flash  # noqa: E402
from repro.kernels.flash_attention import flash_traffic as j_traffic  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.sparse_matmul import (SparsityConfig, nm_matmul,  # noqa: E402
                                            select_impl)
from repro_torch.core.sparsity import NMSparse, pack_indices  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import nm_spmm as tspmm  # noqa: E402
from repro_torch.kernels import nm_spmv as tspmv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402

SHAPES = [(8, 16, 32), (64, 128, 256), (130, 96, 520)]   # the reference's [:3]
NM = [(1, 4), (2, 4), (1, 2)]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _xw(seed, b, o, k, n, m, dtype):
    """Same numpy inputs on both sides: x [b, k], compressed W [o, k]."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((o, k)), _jdt(dtype))
    x = jnp.asarray(rng.standard_normal((b, k)), _jdt(dtype))
    sp = jcompress(w, n, m)
    return (x, sp.values, sp.indices), [_t(a) for a in (x, sp.values,
                                                          sp.indices)]


# ------------------------------------------------------------ nm_spmm (B8)

@pytest.mark.parametrize("nm", NM)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_nm_spmm_plain_matches_reference_kernel(nm, shape, dtype):
    n, m = nm
    r, c, k = shape
    k = -(-k // m) * m
    rng = np.random.default_rng(r + c)
    a = jnp.asarray(rng.standard_normal((r, k)), _jdt(dtype))
    b = jnp.asarray(rng.standard_normal((k, c)), _jdt(dtype))
    sp = jcompress(a, n, m)
    want = kops.nm_spmm(sp.values, sp.indices, b, n, m, interpret=True)
    vt, it, bt = _t(sp.values), _t(sp.indices), _t(b)
    got = tops.nm_spmm(vt, it, bt, n, m)
    assert got.dtype == bt.dtype and got.shape == (r, c)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_array_equal(
        _f32(tspmm.nm_spmm_plain(vt, it, bt, n, m)), _f32(got))


def test_nm_spmm_rejects_mismatched_operands():
    (_, _, _), (xt, vt, it) = _xw(1, 4, 16, 64, 2, 4, "float32")
    with pytest.raises(ValueError, match="do not match"):
        tops.nm_spmm(vt, it, torch.zeros(60, 5), 2, 4)
    with pytest.raises(ValueError, match=r"\[K, C\]"):
        tops.nm_spmm(vt, it, torch.zeros(64), 2, 4)


# ----------------------------------------------------- packed nm_xwt (B2b)

def _ref_block_words(indices, n, m, o, k, block):
    """The reference wrapper's packing (ops.py:72-82): pad to its blocks,
    pack per K-block of bk."""
    bm, bn, bk = block
    op, kp = -(-o // bn) * bn, -(-k // bk) * bk
    nnzp, bnnz = kp // m * n, bk // m * n
    idx = jnp.pad(indices, ((0, op - o), (0, nnzp - indices.shape[1])))
    return np.asarray(jpack(idx.reshape(op, kp // bk, bnnz), m).reshape(op, -1))


# (n, m, (o, k, rows), block): the reference test's cases, 2:8 at its
# word-aligned block, and a K the reference pads (520 -> 1024)
PACKED_CASES = [(1, 2, (192, 512, 24), None), (1, 4, (192, 512, 24), None),
                (2, 4, (192, 512, 24), None), (2, 8, (64, 160, 16), (8, 64, 80)),
                (2, 4, (96, 520, 13), None)]


@pytest.mark.parametrize("n,m,shape,block", PACKED_CASES)
def test_packed_words_equal_reference_per_block_packing(n, m, shape, block):
    o, k, rows = shape
    (_, _, i), (_, _, it) = _xw(3, rows, o, k, n, m, "float32")
    blk = block or kops.pick_block_mm(rows, o, k, n, m)
    ref = _ref_block_words(i, n, m, o, k, blk)
    words = tops.pack_block_indices(it, n, m, blk)
    assert words.dtype == torch.int32
    got = words.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref[:o, :got.shape[1]])
    assert not ref[:o, got.shape[1]:].any()          # the reference's pad
    np.testing.assert_array_equal(pack_indices(it, m).numpy(), got)


@pytest.mark.parametrize("n,m,shape,block", PACKED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_nm_xwt_matches_reference_kernel(n, m, shape, block, dtype):
    o, k, rows = shape
    (x, v, i), (xt, vt, it) = _xw(4, rows, o, k, n, m, dtype)
    want = kops.nm_xwt(x, v, i, n, m, block=block, interpret=True,
                       packed=True)
    got = tops.nm_xwt(xt, vt, it, n, m, packed=True, block=block)
    assert got.dtype == xt.dtype and got.shape == (rows, o)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    # the same function as the int8 stream, bit for bit
    assert torch.equal(got, tops.nm_xwt(xt, vt, it, n, m))


def test_packed_rejects_unaligned_block_as_the_reference():
    (x, v, i), (xt, vt, it) = _xw(5, 8, 32, 48, 2, 4, "float32")
    with pytest.raises(ValueError, match="not a multiple"):
        kops.nm_xwt(x, v, i, 2, 4, block=(8, 32, 24), interpret=True,
                    packed=True)
    with pytest.raises(ValueError, match="not a multiple"):
        tops.nm_xwt(xt, vt, it, 2, 4, block=(8, 32, 24), packed=True)


@pytest.mark.parametrize("nm,k", [((2, 4), 148), ((2, 4), 288), ((2, 4), 432),
                                  ((2, 4), 576), ((1, 4), 148), ((2, 8), 160)])
def test_packed_accepts_and_rejects_the_reference_cnn_cases(nm, k):
    """Under its default block (bk = K rounded to M below 512) the
    reference rejects K = 148 and 432 at 2:4 (bk/M*N = 74, 216: not whole
    16-index words) and accepts 288 and 576; the port decides the same."""
    n, m = nm
    rows, o = 12, 16
    (x, v, i), (xt, vt, it) = _xw(6, rows, o, k, n, m, "float32")
    try:
        kops.nm_xwt(x, v, i, n, m, interpret=True, packed=True)
        ref_ok = True
    except ValueError:
        ref_ok = False
    try:
        tops.nm_xwt(xt, vt, it, n, m, packed=True)
        port_ok = True
    except ValueError:
        port_ok = False
    assert port_ok == ref_ok
    if nm == (2, 4):
        assert ref_ok == (k not in (148, 432))


def test_packed_words_shape_is_checked():
    (_, _, _), (xt, vt, it) = _xw(7, 4, 16, 64, 2, 4, "float32")
    with pytest.raises(ValueError, match="packed words"):
        tspmm.nm_xwt_packed(xt, vt, torch.zeros(16, 3, dtype=torch.int32),
                            2, 4)


# ------------------------------------------------------ onehot nm_spmv (B1b)

@pytest.mark.parametrize("nm", NM + [(2, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 5, 8])
def test_nm_spmv_onehot_plain_matches_reference_kernel(nm, dtype, b):
    n, m = nm
    (x, v, i), (xt, vt, it) = _xw(50 + b, b, 96, 160 if m == 8 else 128,
                                  n, m, dtype)
    want = kops.nm_spmv(x, v, i, n, m, mode="onehot", interpret=True)
    got = tops.nm_spmv(xt, vt, it, n, m, mode="onehot")
    assert got.dtype == xt.dtype and got.shape == (b, 96)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_array_equal(
        _f32(tspmv.nm_spmv_onehot_plain(xt, vt, it, n, m)), _f32(got))


def test_nm_spmv_rejects_unknown_mode():
    (_, _, _), (xt, vt, it) = _xw(8, 2, 16, 64, 2, 4, "float32")
    with pytest.raises(ValueError, match="mode"):
        tops.nm_spmv(xt, vt, it, 2, 4, mode="dense")


# ----------------------------------------- the spmv_mode / decode_impl policy

def _on(shape, cuda):
    """What ``select_impl`` reads of an activation: its shape and device."""
    return types.SimpleNamespace(shape=shape, is_cuda=cuda)


@pytest.mark.parametrize("cuda", [False, True])
def test_select_impl_routes_spmv_mode_and_decode_impl(cuda):
    base = SparsityConfig(mode="compressed")
    onehot = SparsityConfig(mode="compressed", spmv_mode="onehot")
    pinned = SparsityConfig(mode="compressed", decode_impl="ref",
                            spmv_mode="onehot")
    decode, step, prefill = _on((4, 1, 64), cuda), _on((8, 64), cuda), \
        _on((2, 16, 64), cuda)
    if cuda:
        assert select_impl(base, decode) == "spmv"
        assert select_impl(onehot, decode) == "spmv_onehot"
        assert select_impl(onehot, step) == "spmv_onehot"
        assert select_impl(onehot, prefill) == "xwt"
    else:
        for cfg in (base, onehot):
            assert select_impl(cfg, decode) == "plain"
            assert select_impl(cfg, prefill) == "plain"
    # a pinned decode_impl wins for decode shapes, on either device
    assert select_impl(pinned, decode) == "ref"
    assert select_impl(pinned, step) == "ref"
    assert select_impl(pinned, prefill) == ("xwt" if cuda else "plain")
    # a pinned impl wins over both
    top = SparsityConfig(mode="compressed", impl="plain", decode_impl="ref",
                         spmv_mode="onehot")
    assert select_impl(top, decode) == "plain"


def test_nm_matmul_spmv_onehot_matches_reference_body():
    """``impl="spmv_onehot"`` is the reference's ``"spmv_onehot"``: the
    onehot body (its plain version on the CPU; the reference's body runs
    here in interpret mode)."""
    (x, v, i), (xt, vt, it) = _xw(9, 4, 64, 128, 2, 4, "float32")
    want = kops.nm_spmv(x, v, i, 2, 4, mode="onehot", interpret=True)
    got = nm_matmul(xt, NMSparse(vt, it, 2, 4, (64, 128)), impl="spmv_onehot")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------- flash attention (B7)

FLASH_CASES = [
    dict(sq=128, sk=128, causal=True),
    dict(sq=128, sk=128, causal=True, window=32),
    dict(sq=64, sk=128, causal=True),           # suffix queries
    dict(sq=128, sk=128, causal=False),
    dict(sq=128, sk=128, causal=True, cap=30.0),
]


def _qkv(seed, bh, sq, sk, d, dv, dtype):
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal(s), _jdt(dtype))
            for s in ((bh, sq, d), (bh, sk, d), (bh, sk, dv))]
    return arrs, [_t(a) for a in arrs]


def _ftol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_matches_reference_kernel(case, dtype):
    (q, k, v), (qt, kt, vt) = _qkv(0, 4, case["sq"], case["sk"], 64, 64, dtype)
    kw = dict(causal=case["causal"], window=case.get("window"),
              cap=case.get("cap"))
    want = j_flash(q, k, v, block=(32, 64), interpret=True, **kw)
    got = tfa.flash_attention_kernel(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == (4, case["sq"], 64)
    np.testing.assert_allclose(_f32(got), _f32(want), **_ftol(dtype))
    np.testing.assert_array_equal(
        _f32(tfa.flash_attention_plain(qt, kt, vt, **kw)), _f32(got))


@pytest.mark.parametrize("window", [None, 16])
def test_flash_q_off_slice_matches_reference_kernel(window):
    (q, k, v), (qt, kt, vt) = _qkv(1, 4, 128, 128, 64, 64, "float32")
    off, sq = 32, 32
    want = j_flash(q[:, off:off + sq], k, v, causal=True, window=window,
                   q_off=off, block=(32, 64), interpret=True)
    got = tfa.flash_attention_kernel(qt[:, off:off + sq].contiguous(), kt, vt,
                                     causal=True, window=window, q_off=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    full = tfa.flash_attention_kernel(qt, kt, vt, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), full[:, off:off + sq].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_flash_fully_masked_rows_are_zero_as_the_reference():
    """q_off = -8 puts the first 8 queries before every key: their rows are
    masked everywhere and give 0, not NaN (the reference forces p = 0 and
    divides by max(l, 1e-30))."""
    (q, k, v), (qt, kt, vt) = _qkv(2, 2, 32, 64, 64, 64, "float32")
    want = j_flash(q, k, v, causal=True, q_off=-8, block=(32, 64),
                   interpret=True)
    got = tfa.flash_attention_kernel(qt, kt, vt, causal=True, q_off=-8)
    assert bool(torch.isfinite(got).all())
    assert not got[:, :8].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_mla_widths_and_ragged_lengths(dtype):
    """d 192 / dv 128 (deepseek's MLA prefill) against the reference kernel,
    and ragged Sq, Sk (the port masks them in the kernel) against both
    packages' chunked_attention."""
    (q, k, v), (qt, kt, vt) = _qkv(3, 3, 64, 64, 192, 128, dtype)
    want = j_flash(q, k, v, causal=True, block=(32, 64), interpret=True)
    got = tfa.flash_attention_kernel(qt, kt, vt, causal=True)
    assert got.shape == (3, 64, 128)
    np.testing.assert_allclose(_f32(got), _f32(want), **_ftol(dtype))
    (q, k, v), (qt, kt, vt) = _qkv(4, 3, 37, 53, 192, 128, dtype)
    got = tfa.flash_attention_kernel(qt, kt, vt, causal=True, window=20)
    want = j_chunked(*(a.astype(jnp.float32)[:, :, None, :] for a in (q, k, v)),
                     causal=True, window=20)[:, :, 0, :]
    np.testing.assert_allclose(_f32(got), _f32(want), **_ftol(dtype))
    port = chunked_attention(*(a.float()[:, :, None, :] for a in (qt, kt, vt)),
                             causal=True, window=20)[:, :, 0, :]
    np.testing.assert_allclose(_f32(got), port.numpy(), **_ftol(dtype))


@pytest.mark.parametrize("args", [(4, 128, 128, 64, 64), (16, 32768, 32768,
                                                          128, 128),
                                  (8, 512, 1024, 192, 128)])
def test_flash_traffic_matches_reference(args):
    assert tfa.flash_traffic(*args) == j_traffic(*args)


def test_all_ten_launchers_have_their_own_counter():
    names = [k.name for k in tkernels.all_kernels()]
    assert len(names) == 10 and len(set(names)) == 10
    assert {"nm_spmm", "nm_xwt_packed", "nm_spmv_onehot",
            "flash_attention"} <= set(names)
    assert len({id(k) for k in tkernels.all_kernels()}) == 10
