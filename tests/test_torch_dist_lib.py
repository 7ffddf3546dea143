"""The port's library pieces of distribution against the reference's, on
4 gloo ranks on the CPU (one child for all of them): ``compressed_psum``
int8 (equal to 1e-6) and bf16 (within the reference's 0.02 of the mean,
and to 1e-6 of the reference's own) and ``compressed_grad_psum``, with
the reference run in process under ``jax.vmap(..., axis_name=)``;
``moe_a2a_local`` against the reference's under ``vmap`` (error below
1e-3), without drops and with them, in two all-to-alls whose bytes are
the buffers' and no all-gather; ``pipeline_apply`` against the
sequential composition computed in JAX (error below 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engines import one_thread  # noqa: E402,F401
from _torch_tp import run_ranks  # noqa: E402
from repro.dist.moe_a2a import moe_a2a_local as j_moe_a2a  # noqa: E402
from repro.optim.compression import compressed_grad_psum as j_grad_psum  # noqa: E402,E501
from repro.optim.compression import compressed_psum as j_psum  # noqa: E402
from repro_torch.dist.moe_a2a import a2a_bytes  # noqa: E402

N = 4
E, K, D, DFF, T = 8, 2, 32, 48, 32
CAPS = (T, 3)                        # no drops; drops
S, M, MB, PD = 4, 8, 2, 16


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    return dict(
        x=rng.standard_normal((N, 64)).astype(f),
        g={"a": rng.standard_normal((N, 5, 7)).astype(f),
           "b": rng.standard_normal((N, 33)).astype(f)},
        router=(rng.standard_normal((E, D)) * 0.5).astype(f),
        wg=(rng.standard_normal((E, DFF, D)) * 0.2).astype(f),
        wu=(rng.standard_normal((E, DFF, D)) * 0.2).astype(f),
        wd=(rng.standard_normal((E, D, DFF)) * 0.2).astype(f),
        xt=rng.standard_normal((T, D)).astype(f),
        pw=(rng.standard_normal((S, PD, PD)) * 0.2).astype(f),
        px=rng.standard_normal((M, MB, PD)).astype(f))


_BODY = r'''
def body(mesh, path):
    import numpy as np
    from repro_torch.dist.api import make_train_mesh
    from repro_torch.dist.moe_a2a import moe_a2a_local
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.optim import compressed_grad_psum, compressed_psum
    inp = torch.load(path, weights_only=False)
    tm = make_train_mesh((%d,), device="cpu", names=("pod",))
    r = tm.rank
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = {m: compressed_psum(t(inp["x"][r]), tm, "pod", m).tolist()
           for m in ("int8", "bf16")}
    out["grads"] = {k: v.tolist() for k, v in compressed_grad_psum(
        {k: t(v[r]) for k, v in inp["g"].items()}, tm, "pod").items()}
    ax = tm.axis("pod")
    el = %d // ax.size
    tl = inp["xt"].shape[0] // ax.size
    out["moe"] = {}
    for cap in %r:
        tm.reset_stats()
        y = moe_a2a_local(t(inp["xt"][r * tl:(r + 1) * tl]), t(inp["router"]),
                          t(inp["wg"][r * el:(r + 1) * el]),
                          t(inp["wu"][r * el:(r + 1) * el]),
                          t(inp["wd"][r * el:(r + 1) * el]), ax, %d, %d,
                          cap_per_pair=cap)
        out["moe"][str(cap)] = dict(y=y.tolist(), stats=dict(tm.stats))
    tm.reset_stats()
    stage = lambda w, x: torch.tanh(x @ w)
    out["pipe"] = pipeline_apply(stage, t(inp["pw"]), t(inp["px"]),
                                 ax).tolist()
    out["pipe_stats"] = dict(tm.stats)
    return out
''' % (N, E, CAPS, E, K)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lib")
    torch.save(_inputs(), tmp / "inputs.pt")
    return run_ranks(_BODY, N, tmp / "out", tmp / "inputs.pt")


@pytest.mark.parametrize("method", ["int8", "bf16"])
def test_compressed_psum_matches_reference(ranks, method):
    x = _inputs()["x"]
    want = np.asarray(jax.vmap(lambda v: j_psum(v, "pod", method),
                               axis_name="pod")(x))
    for r, res in enumerate(ranks):
        got = np.asarray(res[method], np.float32)
        np.testing.assert_allclose(got, want[r], rtol=0, atol=1e-6)
        # the reference's own gate against the exact mean
        bound = 0.02 if method == "bf16" else 0.05
        assert np.abs(got - x.mean(0)).max() < bound


def test_compressed_grad_psum_matches_reference(ranks):
    g = _inputs()["g"]
    want = jax.vmap(lambda t: j_grad_psum(t, "pod"), axis_name="pod")(
        {k: jnp.asarray(v) for k, v in g.items()})
    for r, res in enumerate(ranks):
        for k in g:
            np.testing.assert_allclose(np.asarray(res["grads"][k]),
                                       np.asarray(want[k][r]), rtol=0,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cap", CAPS)
def test_moe_a2a_local_matches_reference(ranks, cap):
    inp = _inputs()
    el, tl = E // N, T // N
    f = jax.vmap(lambda x, g, u, d: j_moe_a2a(
        x, inp["router"], g, u, d, "ep", E, K, cap_per_pair=cap),
        axis_name="ep")
    want = np.asarray(f(inp["xt"].reshape(N, tl, D),
                        inp["wg"].reshape(N, el, DFF, D),
                        inp["wu"].reshape(N, el, DFF, D),
                        inp["wd"].reshape(N, el, D, DFF)))
    for r, res in enumerate(ranks):
        got = res["moe"][str(cap)]
        assert np.abs(np.asarray(got["y"]) - want[r]).max() < 1e-3
        st = got["stats"]
        # dispatch (rows + int32 expert ids) and return: two exchanges of
        # the fixed-capacity buffers, and nothing all-gathered
        assert st["a2a_bytes"] == a2a_bytes(N, cap, D, 4)
        assert st["gather_bytes"] == st["fsdp_gather_bytes"] == 0


def test_moe_a2a_local_matches_dense_route_without_drops(ranks):
    """At ``cap_per_pair = T`` nothing drops: the dense per-token route
    (the reference test's own check)."""
    inp = _inputs()
    xt, router = inp["xt"], inp["router"]
    logits = xt @ router.T
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    gate = np.take_along_axis(probs, ids, -1)
    gate /= gate.sum(-1, keepdims=True)
    ref = np.zeros((T, D))
    for t in range(T):
        for j in range(K):
            e = ids[t, j]
            g = inp["wg"][e] @ xt[t]
            h = g / (1 + np.exp(-g)) * (inp["wu"][e] @ xt[t])
            ref[t] += gate[t, j] * (inp["wd"][e] @ h)
    got = np.concatenate([np.asarray(r["moe"][str(T)]["y"]) for r in ranks])
    assert np.abs(got - ref).max() < 1e-3


def test_pipeline_apply_matches_sequential(ranks):
    inp = _inputs()
    ref = jnp.asarray(inp["px"])
    for s in range(S):
        ref = jax.vmap(lambda xb: jnp.tanh(xb @ inp["pw"][s]))(ref)
    for res in ranks:
        assert np.abs(np.asarray(res["pipe"]) - np.asarray(ref)).max() < 1e-5
    # neighbour to neighbour: M + S - 2 sends of one microbatch a rank
    st = ranks[0]["pipe_stats"]
    assert st["p2p_bytes"] == (M + S - 2) * MB * PD * 4
    assert st["gather_bytes"] == 0 and st["a2a_bytes"] == 0
