"""Port parity for the CNN path, the paper's own domain: ``im2col`` and
``conv2d_sparse`` against the reference on the example's four layers, a
7x7 stride-2 stem (K 147 -> 148), a 7x1 and a 1x1 layer, in f32 and bf16,
with JAX-drawn weights carried over by ``from_reference_nmsparse``; the
layer tables; ``sparse_conv_init``'s layout; and the CLI on the CPU.

Tolerances: 1e-4 (f32) and 2e-2 (bf16), the reference kernels' own; the
patches themselves are copies and must be equal exactly."""

import pkgutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.sparsity import decompress as jdecompress  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.convert import from_reference_nmsparse, to_torch  # noqa: E402
from repro_torch.core.sparsity import decompress, validate_nm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import cnn as tlaunch  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

DTYPES = ["float32", "bfloat16"]

# (name, c_in, c_out, kh, kw, stride, H, W): the example's four layers on a
# 16x16 input, a 7x7 stride-2 stem (asymmetric SAME pad 2/3, K 147 -> 148),
# a 7x1 (pad 3/3 on H, none on W) and a 1x1 layer
LAYERS = [("ex1", 3, 32, 3, 3, 1, 16, 16), ("ex2", 32, 64, 3, 3, 2, 16, 16),
          ("ex3", 64, 64, 3, 3, 1, 8, 8), ("ex4", 64, 128, 3, 3, 2, 8, 8),
          ("stem7x7", 3, 16, 7, 7, 2, 20, 20), ("mix7x1", 24, 16, 7, 1, 1, 9, 9),
          ("tr1x1", 32, 24, 1, 1, 1, 7, 7)]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _input(seed, b, h, w, c, dtype):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((b, h, w, c)),
                    _jdt(dtype))
    return x, to_torch(np.asarray(x), "cpu")


@pytest.mark.parametrize("layer", LAYERS, ids=[lay[0] for lay in LAYERS])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_im2col_equals_reference(layer, padding, dtype):
    _, c_in, _, kh, kw, stride, h, w = layer
    x, xt = _input(1, 2, h, w, c_in, dtype)
    want, (jho, jwo) = jcnn.im2col(x, kh, kw, stride, padding)
    got, (ho, wo) = tcnn.im2col(xt, kh, kw, stride, padding)
    assert (ho, wo) == (jho, jwo)
    assert got.shape == want.shape and got.dtype == xt.dtype
    # the kernels take dense rows only; at batch 1 the reshape is a view
    assert got.is_contiguous()
    assert tcnn.im2col(xt[:1], kh, kw, stride, padding)[0].is_contiguous()
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("size,k,stride,pads", [(224, 7, 2, (2, 3)),
                                                (64, 3, 2, (0, 1)),
                                                (17, 7, 1, (3, 3)),
                                                (17, 1, 1, (0, 0))])
def test_same_padding_is_the_reference_split(size, k, stride, pads):
    assert tcnn.same_pads(size, k, stride) == pads


@pytest.mark.parametrize("layer", LAYERS, ids=[lay[0] for lay in LAYERS])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv2d_sparse_matches_reference(layer, dtype):
    name, c_in, c_out, kh, kw, stride, h, w = layer
    jsp = jcnn.sparse_conv_init(jax.random.PRNGKey(len(name)), c_in, c_out,
                                kh, kw, 2, 4, dtype=_jdt(dtype))
    sp = from_reference_nmsparse(jsp, "cpu")
    x, xt = _input(2, 2, h, w, c_in, dtype)
    want = jcnn.conv2d_sparse(x, jsp, kh, kw, stride, impl="xla")
    for impl in ("auto", "plain", "ref", "xwt"):
        got = tcnn.conv2d_sparse(xt, sp, kh, kw, stride, impl=impl)
        assert got.shape == want.shape and got.dtype == xt.dtype, impl
        np.testing.assert_allclose(_f32(got), _f32(want), err_msg=impl,
                                   **_tol(dtype))


def test_conv2d_sparse_matches_reference_kernel_route():
    """The stem through the reference's Pallas route (interpret mode)."""
    jsp = jcnn.sparse_conv_init(jax.random.PRNGKey(3), 3, 16, 7, 7, 1, 4)
    sp = from_reference_nmsparse(jsp, "cpu")
    x, xt = _input(3, 1, 12, 12, 3, "float32")
    want = jcnn.conv2d_sparse(x, jsp, 7, 7, 2, impl="pallas_interpret")
    got = tcnn.conv2d_sparse(xt, sp, 7, 7, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("layer", LAYERS[:2] + LAYERS[4:5],
                         ids=["ex1", "ex2", "stem7x7"])
def test_paper_orientation_equals_the_conv(layer):
    """C = A_sp . cols^T (``ops.nm_spmm``, the orientation fig 11 measures)
    is the transposed conv output, and the dense conv of the same pruned
    weights agrees with both."""
    name, c_in, c_out, kh, kw, stride, h, w = layer
    jsp = jcnn.sparse_conv_init(jax.random.PRNGKey(7), c_in, c_out, kh, kw,
                                2, 4)
    sp = from_reference_nmsparse(jsp, "cpu")
    x, xt = _input(4, 2, h, w, c_in, "float32")
    y = tcnn.conv2d_sparse(xt, sp, kh, kw, stride)
    cols, _ = tcnn.im2col(xt, kh, kw, stride)
    cols = torch.nn.functional.pad(cols, (0, sp.dense_shape[1] - cols.shape[1]))
    c = tops.nm_spmm(sp.values, sp.indices, cols.t().contiguous(), 2, 4)
    np.testing.assert_allclose(c.t().numpy(), y.reshape(-1, c_out).numpy(),
                               rtol=1e-4, atol=1e-4)
    dense = tcnn.conv2d_dense(xt, decompress(sp), c_in, kh, kw, stride)
    np.testing.assert_allclose(dense.numpy(), y.numpy(), rtol=1e-4, atol=1e-4)
    wd = jdecompress(jsp)[:, :c_in * kh * kw].reshape(c_out, c_in, kh, kw)
    want = jax.lax.conv_general_dilated(
        x, wd.transpose(2, 3, 1, 0), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_conv_init_layout(dtype):
    """ck padded to a multiple of M with zero columns, then compressed: the
    reference's layout (the two generators cannot agree on values)."""
    g = torch.Generator().manual_seed(0)
    sp = tcnn.sparse_conv_init(g, 3, 16, 7, 7, 2, 4, dtype=dtype,
                               device="cpu")
    assert sp.dense_shape == (16, 148) and sp.values.dtype == dtype
    assert sp.values.shape == (16, 74) and validate_nm(sp)
    jsp = jcnn.sparse_conv_init(jax.random.PRNGKey(0), 3, 16, 7, 7, 2, 4,
                                dtype=_jdt("bfloat16" if dtype == torch.bfloat16
                                           else "float32"))
    assert tuple(jsp.dense_shape) == sp.dense_shape
    assert tuple(jsp.values.shape) == tuple(sp.values.shape)
    dense = decompress(sp)
    assert not dense[:, 147:].any()
    std = float(dense[:, :147].float().pow(2).sum() / (16 * 147 / 2)) ** 0.5
    assert 0.5 * 147 ** -0.5 < std < 2 * 147 ** -0.5


def test_layer_tables_equal_the_reference():
    assert tcnn.CNN_LAYER_GEMMS == jcnn.CNN_LAYER_GEMMS
    for net, convs in tcnn.CNN_LAYER_CONVS.items():
        gemms = {name: (r, k, sp) for name, r, k, sp in tcnn.CNN_LAYER_GEMMS[net]}
        assert [c[0] for c in convs] == [g[0] for g in tcnn.CNN_LAYER_GEMMS[net]]
        for name, c_in, c_out, kh, kw, stride, h in convs:
            out = -(-h // stride)
            assert gemms[name] == (c_out, c_in * kh * kw, out * out), name


def test_cli_runs_on_cpu(capsys):
    tlaunch.main(["--device", "cpu", "--iters", "1"])
    out = capsys.readouterr().out
    assert "sparse-vs-dense max|err|" in out and "ms/fwd" in out
    err = float(out.split("max|err| = ")[1].split()[0])
    assert err < 1e-4
    assert "(53.12%)" in out


def test_new_modules_are_walked_by_the_import_check():
    """tests/test_torch_mla_moe.py imports every module that
    ``pkgutil.walk_packages`` finds and checks that none pulls in jax or
    the reference; the CNN modules are among them."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.models.cnn", "repro_torch.launch.cnn"} <= names
