"""Port parity: the N:M format (repro_torch.core.sparsity) against the
reference (repro.core.sparsity).  Integer results must match bitwise:
selected values, int8 in-block indices and packed uint32 index words, tied
magnitudes included."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import sparsity as jsp  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402

NM = [(1, 2), (1, 4), (2, 4), (2, 8)]
DTYPES = ["float32", "bfloat16"]


def _weights(seed, dtype, rows=24, k=64):
    """Random rows plus rows of tied magnitudes (equal pairs, a constant
    row, sign-flipped ties, zeros) — where top_k's lower-index rule
    decides."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((rows, k)).astype(np.float32)
    w[0] = 1.0
    w[1] = -1.0
    w[2, ::2] = 0.5
    w[2, 1::2] = -0.5
    w[3] = 0.0
    w[4:8, 1::2] = w[4:8, 0::2]
    w[8:10] = np.round(w[8:10])
    wj = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return wj, to_torch(np.asarray(wj), "cpu")


@pytest.mark.parametrize("nm", NM)
@pytest.mark.parametrize("dtype", DTYPES)
def test_compress_bitwise(nm, dtype):
    n, m = nm
    wj, wt = _weights(0, dtype)
    a, b = jsp.compress(wj, n, m), tsp.compress(wt, n, m)
    np.testing.assert_array_equal(np.asarray(a.indices), b.indices.numpy())
    assert b.indices.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(a.values.astype(jnp.float32)),
                                  b.values.float().numpy())
    assert b.values.dtype == wt.dtype
    assert b.dense_shape == tuple(wj.shape)
    assert tsp.validate_nm(b)


@pytest.mark.parametrize("nm", NM)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_indices_bitwise(nm, dtype):
    n, m = nm
    wj, wt = _weights(1, dtype, rows=8, k=96 if m != 8 else 128)
    a, b = jsp.compress(wj, n, m), tsp.compress(wt, n, m)
    pa = np.asarray(jsp.pack_indices(a.indices, m))
    pb = tsp.pack_indices(b.indices, m).numpy()
    assert pa.dtype == pb.dtype == np.uint32
    np.testing.assert_array_equal(pa, pb)
    nnz = b.indices.shape[-1]
    np.testing.assert_array_equal(
        tsp.unpack_indices(tsp.pack_indices(b.indices, m), m, nnz).numpy(),
        np.asarray(jsp.unpack_indices(jnp.asarray(pa), m, nnz)))


@pytest.mark.parametrize("nm", NM)
def test_mask_sparsify_decompress_match_reference(nm):
    n, m = nm
    wj, wt = _weights(2, "float32")
    np.testing.assert_array_equal(np.asarray(jsp.nm_mask(wj, n, m)),
                                  tsp.nm_mask(wt, n, m).numpy())
    np.testing.assert_array_equal(np.asarray(jsp.sparsify(wj, n, m)),
                                  tsp.sparsify(wt, n, m).numpy())
    dense = tsp.decompress(tsp.compress(wt, n, m))
    np.testing.assert_array_equal(
        np.asarray(jsp.decompress(jsp.compress(wj, n, m))), dense.numpy())
    assert tsp.validate_nm(dense, n, m)


@pytest.mark.parametrize("packed,full_column", [(True, False), (False, False),
                                                (False, True)])
def test_storage_bytes_match_reference(packed, full_column):
    wj, wt = _weights(3, "bfloat16")
    assert (tsp.storage_bytes(tsp.compress(wt, 2, 4), packed, full_column)
            == jsp.storage_bytes(jsp.compress(wj, 2, 4), packed, full_column))


def test_validate_nm_rejects_broken_indices():
    _, wt = _weights(4, "float32")
    sp = tsp.compress(wt, 2, 4)
    sp.indices[0, 1] = sp.indices[0, 0]            # not strictly increasing
    assert not tsp.validate_nm(sp)
    assert not tsp.validate_nm(torch.ones(2, 8), 2, 4)


def test_compress_rejects_bad_pattern():
    with pytest.raises(ValueError, match="divisible"):
        tsp.compress(torch.ones(2, 6), 2, 4)
    with pytest.raises(ValueError, match="0 < N < M"):
        tsp.compress(torch.ones(2, 8), 4, 4)


def test_bf16_bits_survive_conversion():
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 37), jnp.bfloat16))
    t = to_torch(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))
