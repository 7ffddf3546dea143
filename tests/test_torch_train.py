"""Port parity: the training pieces against the reference, on the same
numpy inputs.  SR-STE (``ste_sparsify`` forward bit-equal, backward
against ``jax.grad`` through the reference's ``custom_vjp``: f32 1e-6,
bf16 2e-2), ``nm_matmul_ste`` / ``masked_matmul`` values and gradients,
the 'fixed' mode through ``linear_init`` / ``linear_apply`` and
``convert_to_compressed`` with a stored mask, ``warmup_cosine``,
``adamw_update`` over three steps with and without f32 masters and
``clip_by_global_norm`` (1e-6), ``SyntheticLMData`` bit-equal, the
optimizer-state conversion both ways, and ``CheckpointManager``'s round
trip, keep-k, async save and partial-write cases."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import layers as jlayers  # noqa: E402
from repro.core import sparse_matmul as jsm  # noqa: E402
from repro.core.sparse_matmul import SparsityConfig as JSparsity  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402
from repro.optim import warmup_cosine as jwarmup  # noqa: E402
from _torch_engines import one_thread  # noqa: E402,F401
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import (from_reference_opt_state,  # noqa: E402
                                 from_reference_params, to_reference_opt_state,
                                 to_reference_tree, to_torch)
from repro_torch.core import layers  # noqa: E402
from repro_torch.core import sparse_matmul as sm  # noqa: E402
from repro_torch.core.sparse_matmul import SparsityConfig  # noqa: E402
from repro_torch.data import SyntheticLMData, to_device  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, clip_by_global_norm,
                               warmup_cosine)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
N, M, LAM = 2, 4, 2e-4


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jnp(a: np.ndarray, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _draw(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------------------------- SR-STE

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ste_sparsify_forward_bit_equal_and_backward(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    w_np, g_np = _draw(0, (64, 32)), _draw(1, (64, 32))
    w_j, g_j = _jnp(w_np, jdt), _jnp(g_np, jdt)
    want = jsm.ste_sparsify(w_j, N, M, LAM)
    dwant = jax.grad(lambda w: jnp.sum(
        (jsm.ste_sparsify(w, N, M, LAM) * g_j).astype(jnp.float32)))(w_j)
    w = to_torch(np.asarray(w_j), "cpu").requires_grad_(True)
    got = sm.ste_sparsify(w, N, M, LAM)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    (got * to_torch(np.asarray(g_j), "cpu")).float().sum().backward()
    assert w.grad.dtype == tdt
    np.testing.assert_allclose(_np(w.grad), np.asarray(dwant, np.float32),
                               rtol=tol, atol=tol)
    # the pruned entries carry the SR-STE decay, the kept ones g alone
    mask = np.asarray(jnp.abs(want) > 0)
    assert not np.allclose(_np(w.grad)[~mask], g_np[~mask])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["ste", "masked"])
def test_sparse_products_values_and_grads(kind, dtype):
    """``nm_matmul_ste`` and ``masked_matmul``: values, d/dx and d/dw
    against ``jax.grad`` of the reference's, result in x's dtype."""
    jdt, tdt, tol = DTYPES[dtype]
    x_j = _jnp(_draw(2, (3, 5, 32)), jdt)
    w_j = _jnp(_draw(3, (24, 32)), jdt)
    g_j = _jnp(_draw(4, (3, 5, 24)), jdt)
    mask_np = np.array(jsm.nm_mask(w_j, N, M))
    if kind == "ste":
        jf = lambda x, w: jsm.nm_matmul_ste(x, w, N, M, LAM)  # noqa: E731
        tf = lambda x, w: sm.nm_matmul_ste(x, w, N, M, LAM)  # noqa: E731
    else:
        mask_j = jnp.asarray(mask_np)
        jf = lambda x, w: jsm.masked_matmul(x, w, mask_j)  # noqa: E731
        tf = lambda x, w: sm.masked_matmul(  # noqa: E731
            x, w, torch.from_numpy(mask_np))
    want = jf(x_j, w_j)
    dx, dw = jax.grad(lambda x, w: jnp.sum(
        (jf(x, w) * g_j).astype(jnp.float32)), argnums=(0, 1))(x_j, w_j)
    x = to_torch(np.asarray(x_j), "cpu").requires_grad_(True)
    w = to_torch(np.asarray(w_j), "cpu").requires_grad_(True)
    got = tf(x, w)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    (got * to_torch(np.asarray(g_j), "cpu")).float().sum().backward()
    for t, ref in ((x, dx), (w, dw)):
        np.testing.assert_allclose(_np(t.grad), np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)
    if kind == "masked":              # autodiff masks the weight gradient
        assert (_np(w.grad)[~mask_np] == 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lm_head_grads_match_reference(dtype):
    """The tied LM head's f32 logits and d/dx, d/demb under an f32
    cotangent against ``jax.vjp`` of the reference's f32-preferred einsum,
    which keeps the cotangent in f32 (the card's ``_HeadMM`` backward
    computes the same products)."""
    from repro.models.common import lm_head_apply as jhead
    from repro_torch.models.common import Embedding, lm_head_apply
    jdt, tdt, tol = DTYPES[dtype]
    x_j = _jnp(_draw(5, (3, 5, 32)), jdt)
    e_j = _jnp(_draw(6, (48, 32)), jdt)
    g_np = _draw(7, (3, 5, 48))
    want, vjp = jax.vjp(lambda x, e: jhead({"emb": e}, x), x_j, e_j)
    dx, de = vjp(jnp.asarray(g_np))
    x = to_torch(np.asarray(x_j), "cpu").requires_grad_(True)
    p = Embedding(to_torch(np.asarray(e_j), "cpu"))
    p.emb.requires_grad_(True)
    got = lm_head_apply(p, x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got.backward(torch.from_numpy(g_np))
    for t, ref in ((x, dx), (p.emb, de)):
        assert t.grad.dtype == tdt
        np.testing.assert_allclose(_np(t.grad), np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)


def test_dense_forward_view_stored_mask_wins():
    """A stored mask applies whatever the mode; 'srste' goes through the
    straight-through view; the policy's skipped shapes stay dense."""
    w = torch.from_numpy(_draw(5, (128, 128)))
    mask = torch.from_numpy(_draw(6, (128, 128)) > 0)
    srste = SparsityConfig(n=N, m=M, mode="srste")
    assert torch.equal(sm.dense_forward_view(w, srste, mask), w * mask)
    assert torch.equal(sm.dense_forward_view(w, srste),
                       sm.ste_sparsify(w, N, M, LAM))
    small = torch.from_numpy(_draw(7, (16, 128)))
    assert sm.dense_forward_view(small, srste) is small


# ------------------------------------------------------------- fixed mode

def test_linear_fixed_mode_and_conversion_with_mask():
    """'fixed': ``linear_init`` stores the magnitude mask (a buffer; w and
    b parameters); ``linear_apply`` through ``masked_matmul`` equals the
    reference's on the converted leaves (``from_reference_params``' path
    carries the mask too); ``convert_to_compressed`` applies the stored
    mask first, bit-equal to the reference's."""
    jcfg = JSparsity(n=N, m=M, mode="fixed", min_dim=64)
    tcfg = SparsityConfig(n=N, m=M, mode="fixed", min_dim=64)
    gen = torch.Generator().manual_seed(0)
    lin = layers.linear_init(gen, 128, 64, tcfg, dtype=torch.float32,
                             device="cpu", use_bias=True)
    assert lin.has("mask") and lin.mask.dtype == torch.bool
    assert "mask" in lin._buffers and "w" in lin._parameters
    assert torch.equal(lin.mask, sm.nm_mask(lin.w, N, M))
    # a mask that differs from the magnitude one, so applying it shows
    mask = np.asarray(_draw(8, (64, 128)) > 0)
    tree = {"w": _draw(9, (64, 128)), "mask": mask,
            "b": _draw(10, (64,))}
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = layers.SparseLinear(**{k: to_torch(v, "cpu")
                                for k, v in tree.items()})
    x = _draw(11, (4, 128))
    want = jlayers.linear_apply(jp, jnp.asarray(x), jcfg)
    got = layers.linear_apply(tp, torch.from_numpy(x), tcfg)
    # f32 sums over K 128 of O(1) terms: the order differs, not the mask
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jc = jlayers.convert_to_compressed(jp, jcfg)
    tc = layers.convert_to_compressed(tp, tcfg)
    np.testing.assert_array_equal(tc.w_vals.numpy(), np.asarray(jc["w_vals"]))
    np.testing.assert_array_equal(tc.w_idx.numpy(), np.asarray(jc["w_idx"]))
    assert not tc.has("mask") and not tc.w_vals.requires_grad


def test_fixed_model_from_reference_params():
    """A 'fixed' smoke llama carried over keeps every mask; its loss equals
    the reference's."""
    from repro.models import loss_fn as jloss
    from repro_torch.models import loss_fn
    jc = jget("llama3.2-1b", smoke=True).replace(n_layers=2)
    tc = tget("llama3.2-1b", smoke=True).replace(n_layers=2)
    jc = jc.replace(sparsity=jc.sparsity.__class__(
        **{**jc.sparsity.__dict__, "mode": "fixed"}))
    tc = tc.replace(sparsity=SparsityConfig(
        **{**tc.sparsity.__dict__, "mode": "fixed"}))
    params, _ = jinit(jax.random.PRNGKey(0), jc)
    model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    masks = [m for m in model.modules() if isinstance(m, layers.SparseLinear)
             and m.has("mask")]
    assert len(masks) == 2 * 7
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    want, _ = jloss(params, jc, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = loss_fn(model, tc, to_device(batch, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# --------------------------------------------------------------- schedule

@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 55, 99, 100, 150])
def test_warmup_cosine(step):
    want = float(jwarmup(step, 3e-4, 10, 100))
    got = warmup_cosine(step, 3e-4, 10, 100)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)
    t = warmup_cosine(torch.tensor(step, dtype=torch.int32), 3e-4, 10, 100)
    assert float(t) == float(got)


# ------------------------------------------------------------------ AdamW

def _param_tree(dtype):
    rng = np.random.default_rng(0)
    return {"a": {"w": rng.standard_normal((8, 16)).astype(np.float32)},
            "b": rng.standard_normal((16,)).astype(np.float32)}, dtype


def _named(tree, dtype):
    return {"a.w": to_torch(np.asarray(tree["a"]["w"]), "cpu").to(dtype),
            "b": to_torch(np.asarray(tree["b"]), "cpu").to(dtype)}


@pytest.mark.parametrize("master", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps(master, dtype):
    """Three clipped AdamW steps (clipping active) against the reference:
    parameters, mu / nu / master / step and gnorm within 1e-6."""
    jdt, tdt, _ = DTYPES[dtype]
    tree, _ = _param_tree(dtype)
    jp = jax.tree.map(lambda a: _jnp(a, jdt), tree)
    named = _named(jax.tree.map(np.asarray, jp), tdt)
    jcfg = JAdamW(master_weights=master, clip_norm=0.5)
    tcfg = AdamWConfig(master_weights=master, clip_norm=0.5)
    jst, st = jadamw_init(jp, jcfg), adamw_init(named, tcfg)
    assert set(st) == set(jst)
    rng = np.random.default_rng(1)
    for i in range(3):
        g = {"a": {"w": rng.standard_normal((8, 16)).astype(np.float32)},
             "b": rng.standard_normal((16,)).astype(np.float32)}
        jg = jax.tree.map(lambda a: _jnp(a, jdt), g)
        jp, jst, jgn = jadamw_update(jg, jst, jp, 1e-2 * (i + 1), jcfg)
        _, st, gn = adamw_update(_named(jax.tree.map(np.asarray, jg), tdt),
                                 st, named, 1e-2 * (i + 1), tcfg)
        assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
    assert named["a.w"].dtype == tdt
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=8e-3, atol=1e-6)      # one bf16 rounding of the result
    np.testing.assert_allclose(_np(named["a.w"]),
                               np.asarray(jp["a"]["w"], np.float32), **tol)
    ref = to_reference_opt_state(st)
    for part in ("mu", "nu") + (("master",) if master else ()):
        for path in (("a", "w"), ("b",)):
            a, b = ref[part], jst[part]
            for key in path:
                a, b = a[key], b[key]
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    assert int(ref["step"]) == int(jst["step"]) == 3


def test_master_weights_keep_tiny_updates():
    """The reference's case: updates bf16 cannot see accumulate in the f32
    master."""
    cfg = AdamWConfig(master_weights=True, clip_norm=1e9)
    p = {"w": torch.ones(8, dtype=torch.bfloat16)}
    st = adamw_init(p, cfg)
    assert st["master"]["w"].dtype == torch.float32
    for _ in range(3):
        adamw_update({"w": torch.full((8,), 1e-4, dtype=torch.bfloat16)}, st,
                     p, 1e-5, cfg)
    assert float((st["master"]["w"] - 1.0).abs().max()) > 0
    assert p["w"].dtype == torch.bfloat16


def test_clip_by_global_norm():
    g = {"a": np.full((10,), 3.0, np.float32), "b": np.full((10,), 4.0,
                                                              np.float32)}
    jc, jgn = jclip(jax.tree.map(jnp.asarray, g), 1.0)
    tc, gn = clip_by_global_norm({k: torch.from_numpy(v)
                                  for k, v in g.items()}, 1.0)
    assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)
    # under the bound nothing moves; bf16 stays bf16
    small = {"a": torch.full((4,), 0.1, dtype=torch.bfloat16)}
    out, _ = clip_by_global_norm(small, 1.0)
    assert out["a"].dtype == torch.bfloat16 and torch.equal(out["a"],
                                                           small["a"])


def test_opt_state_conversion_round_trip():
    """The reference's AdamW state of a smoke llama carried into the port
    (keys = the model's parameter names) and back, bit for bit."""
    jc = jget("llama3.2-1b", smoke=True).replace(n_layers=2,
                                                 dtype="bfloat16")
    tc = tget("llama3.2-1b", smoke=True).replace(n_layers=2,
                                                 dtype="bfloat16")
    params, _ = jinit(jax.random.PRNGKey(0), jc)
    jst = jadamw_init(params, JAdamW(master_weights=True))
    jst = jax.tree.map(lambda a: a + 0.5 if a.dtype == jnp.float32 else a,
                       jst)
    model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    st = from_reference_opt_state(jax.tree.map(np.asarray, jst), model,
                                  device="cpu")
    assert list(st["mu"]) == [n for n, _ in model.named_parameters()]
    assert st["master"]["layers.1.mlp.wd.w"].dtype == torch.float32
    back = to_reference_opt_state(st)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jst):
        got = back
        for p in path:
            got = got[getattr(p, "key", getattr(p, "idx", p))]
        np.testing.assert_array_equal(got, np.asarray(leaf))
    tree = to_reference_tree(dict(model.named_parameters()))
    np.testing.assert_array_equal(
        tree["layers"]["attn"]["wq"]["w"],
        np.asarray(params["layers"]["attn"]["wq"]["w"], np.float32))


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-vl-7b",
                                  "whisper-small"])
def test_synthetic_data_bit_equal(arch):
    """Every batch of the stream equals the reference's, in every input
    mode; skip-ahead restore reproduces it; ``to_device`` keeps dtypes."""
    jd = JData(jget(arch, smoke=True), 4, 16, seed=3)
    td = SyntheticLMData(tget(arch, smoke=True), 4, 16, seed=3)
    for step in (0, 1, 7):
        want, got = jd.batch_at(step), td.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    first = [next(td) for _ in range(3)]
    again = SyntheticLMData(tget(arch, smoke=True), 4, 16, seed=3)
    again.restore(2)
    assert td.state() == 3 and again.state() == 2
    np.testing.assert_array_equal(next(again)["labels"], first[2]["labels"])
    dev = to_device(first[0], "cpu")
    assert dev["labels"].dtype == torch.int32


# ------------------------------------------------------------- checkpoint

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros(tree):
    return {"a": torch.zeros_like(tree["a"]),
            "b": {"c": torch.zeros_like(tree["b"]["c"])},
            "step": torch.zeros_like(tree["step"])}


def test_checkpoint_round_trip(tmp_path):
    """Save and restore into a zero template: values, dtypes, meta; the
    file is the reference's layout (its manager reads the keys)."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(5, t, extra={"data_state": 7}, blocking=True)
    assert mgr.latest_step() == 5
    restored, meta = mgr.restore(5, _zeros(t))
    assert meta["step"] == 5 and meta["data_state"] == 7
    assert restored["b"]["c"].dtype == torch.bfloat16
    for k in ("a", "step"):
        assert torch.equal(restored[k], t[k])
    assert torch.equal(restored["b"]["c"], t["b"]["c"])
    z = np.load(os.path.join(str(tmp_path), "step_0000000005", "host0.npz"))
    assert z["b/c"].dtype == np.float32       # bf16 upcast, as the reference
    jt, _ = JManager(str(tmp_path)).restore(
        5, {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(4, jnp.bfloat16)},
            "step": jnp.zeros((), jnp.int32)})
    np.testing.assert_array_equal(np.asarray(jt["a"]), t["a"].numpy())
    mgr.close()


def test_checkpoint_module_and_shape_check(tmp_path):
    """An ``nn.Module`` flattens by its state_dict names and restores in
    place; a template of another shape raises."""
    lin = layers.SparseLinear(w=torch.randn(4, 8), b=torch.randn(4))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (lin, {"mu": {"w": torch.ones(4, 8)}}), blocking=True)
    other = layers.SparseLinear(w=torch.zeros(4, 8), b=torch.zeros(4))
    mu = {"mu": {"w": torch.zeros(4, 8)}}
    mgr.restore(1, (other, mu))
    assert torch.equal(other.w, lin.w) and torch.equal(other.b, lin.b)
    assert torch.equal(mu["mu"]["w"], torch.ones(4, 8))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, (layers.SparseLinear(w=torch.zeros(4, 4),
                                            b=torch.zeros(4)), mu))
    mgr.close()


def test_checkpoint_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(), blocking=True)
    assert mgr.all_steps() == [3, 4]
    mgr.close()


def test_checkpoint_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=False)
    mgr.save(2, _tree(), blocking=False)       # drains the first write
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    mgr.close()


def test_checkpoint_partial_write_ignored(tmp_path):
    """A directory without COMMIT (killed mid-write) is not visible."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    bad = os.path.join(str(tmp_path), "step_0000000009")
    os.makedirs(bad)
    with open(os.path.join(bad, "meta.json"), "w") as f:
        f.write("{}")
    assert mgr.latest_step() == 1
    mgr.close()
