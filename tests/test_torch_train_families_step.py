"""Port parity: the training step for the MoE / MLA, gemma2, SSM, hybrid,
audio and vlm families, at smoke size in f32 from converted weights.

One and three ``make_train_step`` steps against the reference's, each
from the reference's state (loss and gradient norm within 1e-5 relative;
mu and nu within 1e-4; parameters within 1e-4 where Adam's update is
well conditioned, the router and the mixers' f32 leaves among them).
The optimizer and the loop are ``tests/test_torch_train_families_loop.py``,
train -> compress -> serve and the CLI
``tests/test_torch_train_families_serve.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from _torch_engines import one_thread, pair  # noqa: E402,F401
from repro_torch.convert import (from_reference_opt_state,  # noqa: E402
                                 from_reference_params,
                                 to_reference_opt_state, to_reference_tree)
from repro_torch.data import SyntheticLMData, to_device  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

FAMILIES = ["deepseek-v2-lite-16b", "gemma2-9b", "falcon-mamba-7b",
            "zamba2-7b", "whisper-small", "qwen2-vl-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)
_JSTEPS = {}


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got_tree, want_tree, **tol):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _jstep(arch, jc):
    """The reference's jitted step, compiled once per arch in this file."""
    if arch not in _JSTEPS:
        _JSTEPS[arch] = jax.jit(jmake_step(jc, JAdamW(master_weights=False),
                                           base_lr=1e-3, warmup=2))
    return _JSTEPS[arch]


def _close_params(got_tree, want_tree, nu, t, lr):
    """Parameters after the step at ``t`` within 1e-4, except where Adam's
    update is ill-conditioned: with the reference's sqrt(nu-hat) below
    1e-6, u = m-hat / (sqrt(nu-hat) + 1e-8) turns on gradient digits
    beneath the gradients' own agreement (1e-4; a gradient of 1e-9 that
    two summation orders give as 1e-9 and 3e-9 moves u by a third), so
    those elements are held to what one update can move a parameter by,
    2 lr."""
    got, want = _leaves(got_tree), _leaves(want_tree)
    vhat = {k: v / (1 - 0.95 ** t) for k, v in _leaves(nu).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        ill = np.sqrt(vhat[k]) < 1e-6
        np.testing.assert_allclose(got[k][~ill], want[k][~ill], err_msg=k,
                                   **TOL)
        assert np.all(np.abs(got[k][ill] - want[k][ill]) <= 2 * lr + 1e-6), k


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch, n_steps):
    """``make_train_step`` on the same weights, optimizer state and batches
    as the reference's (lr past zero from the first step; steps 2 and 3
    run with nonzero moments, bias corrections and the warmup's next lr).
    Before each step the port takes the reference's parameters and state:
    a few elements' ill-conditioned updates (``_close_params``) would
    otherwise seed differences that the next steps' forward amplifies, so
    each step is held to the reference from the same state."""
    jc, params, tc, _ = pair(arch)
    jc, tc = jc.replace(grad_accum=1), tc.replace(grad_accum=1)
    jo = jadamw_init(params, JAdamW(master_weights=False))
    jstep = _jstep(arch, jc)
    tstep = make_train_step(tc, AdamWConfig(master_weights=False),
                            base_lr=1e-3, warmup=2)
    for i in range(n_steps):
        model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                      device="cpu")
        to = from_reference_opt_state(jax.tree.map(np.asarray, jo), model,
                                      device="cpu", cfg=tc)
        b = SyntheticLMData(tc, 2, 16, seed=i).batch_at(0)
        params, jo, jm = jstep(params, jo, jax.tree.map(jnp.asarray, b),
                               jnp.int32(i + 1))
        model, to, tm = tstep(model, to, to_device(b, "cpu"), i + 1)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]),
                                                   rel=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        st = to_reference_opt_state(to, tc)
        _close({"mu": st["mu"], "nu": st["nu"]},
               {"mu": jo["mu"], "nu": jo["nu"]}, **TOL)
        _close_params(to_reference_tree(dict(model.named_parameters()), tc),
                      params, jo["nu"], i + 1, float(jm["lr"]))
        assert int(st["step"]) == int(jo["step"]) == i + 1
