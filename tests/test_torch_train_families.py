"""Port parity: training of the MoE / MLA, gemma2, SSM, hybrid, audio and
vlm families against the reference, at smoke size in f32.

``loss_fn``'s loss and every gradient (router, the mixers' f32 leaves and
the shared block included) against ``jax.value_and_grad`` of the
reference's on converted weights (loss within 1e-5 relative, gradients
1e-4); the MoE aux term on its own (value and gradients); the Mamba1 scan
forward bit-equal to the in-place scan it replaced (kept here as the
oracle) and its backward against autograd of the recurrence; remat on
against off for the SSM, hybrid and audio stacks (the checkpoints
counted); ``attn_chain_bf16`` against the reference's chained attention.
The conversion to and from the reference's tree is
``tests/test_torch_train_convert.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import loss_fn as jloss  # noqa: E402
from _torch_engines import one_thread, pair  # noqa: E402,F401
from repro_torch.convert import from_reference_params  # noqa: E402
from repro_torch.convert import to_reference_tree  # noqa: E402
from repro_torch.data import SyntheticLMData, to_device  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.launch.steps import named_params  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

FAMILIES = ["deepseek-v2-lite-16b", "gemma2-9b", "falcon-mamba-7b",
            "zamba2-7b", "whisper-small", "qwen2-vl-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)
# the f32 leaves a bf16 model of these families trains beside its weights
F32_LEAVES = {"deepseek-v2-lite-16b": ("router",),
              "falcon-mamba-7b": ("conv_w", "conv_b", "A_log", "D"),
              "zamba2-7b": ("conv_w", "conv_b", "A_log", "D", "dt_bias")}


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got_tree, want_tree, **tol):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _pair(arch):
    """``pair(arch)`` with a model of its own: the trainer turns on the
    parameters' gradients, and the cached model is shared with other
    files."""
    jc, params, tc, _ = pair(arch)
    return jc, params, tc, from_reference_params(
        jax.tree.map(np.asarray, params), tc, device="cpu")


def _batch(cfg, seed=3, b=2, s=16):
    return SyntheticLMData(cfg, b, s, seed=seed).batch_at(0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """The port's loss and gradients of every parameter against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` (the MoE aux
    term, the router, the mixers' conv / A_log / D / dt_bias, gemma2's
    pairs, the hybrid's shared block, the encoder and cross-attention)."""
    jc, params, tc, model = _pair(arch)
    b = _batch(tc)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, x: jloss(p, jc, x), has_aux=True))(
            params, jax.tree.map(jnp.asarray, b))
    loss, grads = loss_and_grads(model, tc, to_device(b, "cpu"))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    leaves = {n.rsplit(".", 1)[-1] for n in grads}
    assert set(F32_LEAVES.get(arch, ())) <= leaves
    _close(to_reference_tree(grads, tc), jg, **TOL)


def test_moe_aux_matches_reference():
    """deepseek's load-balance term alone: its value (summed over the MoE
    blocks, divided by their count) and its gradients (the router's and
    those reaching the layers below through the routing probabilities)."""
    jc, params, tc, model = _pair("deepseek-v2-lite-16b")
    b = _batch(tc, seed=5)
    jaux, jg = jax.jit(jax.value_and_grad(
        lambda p, x: jforward(p, jc, x)[1]))(params,
                                             jax.tree.map(jnp.asarray, b))
    named = named_params(model)
    _, aux = transformer.forward(model, tc, to_device(b, "cpu"))
    assert float(aux.detach()) == pytest.approx(float(jaux), rel=1e-5)
    grads = torch.autograd.grad(aux, list(named.values()), allow_unused=True)
    got = {k: (g if g is not None else torch.zeros_like(p))
           for (k, p), g in zip(named.items(), grads)}
    assert float(got["layers.0.moe.router"].abs().max()) > 0
    _close(to_reference_tree(got, tc), jg, **TOL)


def _scan_in_place(dt, bmat, cmat, xs, a, chunk):
    """The Mamba1 scan as it was written before training came: each level
    of the log-depth scan written into the chunk's tensors in place (the
    forward the autograd-safe scan must equal bit for bit)."""
    bb, s, di = xs.shape
    h = torch.zeros((bb, di, a.shape[1]), dtype=torch.float32)
    ys = []
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        dtk = dt[:, c0:c1]
        acc_a = torch.exp(dtk[..., None] * a)
        acc_b = (dtk * xs[:, c0:c1])[..., None] * bmat[:, c0:c1, None, :]
        off = 1
        while off < c1 - c0:
            acc_b[:, off:] = acc_b[:, :-off] * acc_a[:, off:] + acc_b[:, off:]
            acc_a[:, off:] = acc_a[:, :-off] * acc_a[:, off:]
            off *= 2
        h_all = acc_b + acc_a * h[:, None]
        ys.append(torch.einsum("bcds,bcs->bcd", h_all, cmat[:, c0:c1]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def _scan_inputs(seed=6, b=2, s=37, di=12, st=5):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(x, dtype=torch.float32)
    return (t(rng.uniform(0.01, 1.0, (b, s, di))),
            t(rng.normal(size=(b, s, st))), t(rng.normal(size=(b, s, st))),
            t(rng.normal(size=(b, s, di))),
            -t(rng.uniform(0.5, 4.0, (di, st))))


def test_mamba1_scan_forward_is_bit_equal_to_the_in_place_scan():
    """The same products in the same order: y and the last state equal the
    in-place scan's bit for bit, chunk 1, a ragged last chunk and a chunk
    past S alike (so no served token moves)."""
    args = _scan_inputs()
    for chunk in (1, 8, 16, 64):
        y, h = tssm.mamba1_scan(*args, chunk)
        wy, wh = _scan_in_place(*args, chunk)
        assert torch.equal(y, wy) and torch.equal(h, wh), chunk


def test_mamba1_scan_backward_is_the_recurrence():
    """Gradients through the log-depth scan (every input, the last state
    included) against autograd of the plain recurrence."""
    base = _scan_inputs(seed=7, s=21)
    rng = np.random.default_rng(8)
    wy = torch.tensor(rng.normal(size=base[3].shape), dtype=torch.float32)
    wh = torch.tensor(rng.normal(size=(2, 12, 5)), dtype=torch.float32)

    def grads(fn):
        args = [x.clone().requires_grad_(True) for x in base]
        y, h = fn(*args)
        torch.autograd.backward([(y * wy).sum() + (h * wh).sum()])
        return [x.grad for x in args]

    def recurrence(dt, bm, cm, xs, a):
        h = torch.zeros(2, 12, 5)
        ys = []
        for t in range(dt.shape[1]):
            h = torch.exp(dt[:, t, :, None] * a) * h \
                + (dt[:, t] * xs[:, t])[..., None] * bm[:, t, None, :]
            ys.append(torch.einsum("bds,bs->bd", h, cm[:, t]))
        return torch.stack(ys, 1), h

    want = grads(recurrence)
    for chunk in (1, 8, 64):
        for g, w in zip(grads(lambda *a: tssm.mamba1_scan(*a, chunk)), want):
            torch.testing.assert_close(g, w, **TOL)


def _stack_checkpoints(n, g):
    """Checkpoints a remat stack of n blocks makes in one forward and
    backward: one per block; with g groups dividing n, also one per group,
    and the group's recompute enters its blocks' checkpoints again."""
    return n if not g or n % g else g + 2 * n


@pytest.mark.parametrize("group", [0, 2])
@pytest.mark.parametrize("arch,checkpoints", [
    ("falcon-mamba-7b", lambda g: _stack_checkpoints(4, g)),
    # 2 groups of 2 Mamba blocks, each group (with its shared block) a
    # checkpoint around its blocks' own: groups are never regrouped
    ("zamba2-7b", lambda g: 2 + 2 * 2 * 2),
    # the encoder's 2 blocks, then the decoder's 4
    ("whisper-small",
     lambda g: _stack_checkpoints(2, g) + _stack_checkpoints(4, g)),
])
def test_remat_gives_the_gradients_of_no_remat(arch, checkpoints, group,
                                               monkeypatch):
    """The SSM, hybrid and audio stacks checkpoint their blocks (and
    groups) under autograd: the gradients equal those without remat bit
    for bit, and the checkpoints are counted; a pass without autograd
    checkpoints nothing."""
    _, _, tc, model = _pair(arch)
    b = to_device(_batch(tc, seed=2), "cpu")
    calls = []
    real = transformer._checkpoint
    monkeypatch.setattr(transformer, "_checkpoint",
                        lambda fn, *a: calls.append(1) or real(fn, *a))
    _, off = loss_and_grads(model, tc.replace(remat=False), b)
    assert not calls
    with torch.no_grad():
        transformer.forward(model, tc.replace(remat=True), b)
    assert not calls
    cfg = tc.replace(remat=True, remat_group=group)
    _, on = loss_and_grads(model, cfg, b)
    assert len(calls) == checkpoints(group)
    for k in off:
        assert torch.equal(on[k], off[k]), k


@pytest.mark.parametrize("case", [
    dict(causal=True, window=None, cap=None, sq=64, sk=64),
    dict(causal=True, window=24, cap=50.0, sq=64, sk=64),
    dict(causal=False, window=None, cap=None, sq=32, sk=96)])
def test_chunked_attention_chain_bf16_matches_reference(case):
    """bf16 score and probability tiles: within 2e-3 of the reference's
    chained attention (a score whose f32 value differs in its last bit
    between the two einsums may round to the other bf16 neighbour: one
    bf16 step, 2^-8 of a probability), and at least 4x closer to it than
    the unchained attention is (the rounding is real and it is the
    reference's)."""
    rng = np.random.default_rng(0)
    case = dict(case)
    sq, sk = case.pop("sq"), case.pop("sk")
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    want = np.asarray(jattn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), q_chunk=16, kv_chunk=32,
        chain_bf16=True, **case))

    def port(chain):
        return tattn.chunked_attention(
            *map(torch.tensor, (q, k, v)), q_chunk=16, kv_chunk=32,
            chain_bf16=chain, **case).numpy()
    chained = np.abs(port(True) - want)
    np.testing.assert_allclose(port(True), want, rtol=2e-3, atol=2e-3)
    assert np.abs(port(False) - want).mean() > 4 * chained.mean()


@pytest.mark.parametrize("arch", ["gemma2-9b", "whisper-small"])
def test_chain_bf16_training_matches_reference(arch):
    """``attn_chain_bf16=True`` through the whole loss (within 1e-5
    relative) and its gradients (gemma2: windowed, softcapped
    self-attention; whisper: the encoder's and the cross-attention's
    chunked reads).  The backward rounds each tile's cotangent to bf16 in
    both packages, so a last-bit difference upstream moves a gradient by
    bf16 steps: gradients are held to the bf16 tolerance, 2e-2
    (``tests/test_kernels.py``)."""
    jc, params, tc, _ = pair(arch)
    jc, tc = jc.replace(attn_chain_bf16=True), tc.replace(attn_chain_bf16=True)
    model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    b = _batch(tc, seed=4)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, x: jloss(p, jc, x), has_aux=True))(
            params, jax.tree.map(jnp.asarray, b))
    loss, grads = loss_and_grads(model, tc, to_device(b, "cpu"))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    _close(to_reference_tree(grads, tc), jg, rtol=2e-2, atol=2e-2)
