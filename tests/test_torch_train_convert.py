"""Port parity: the conversion between the reference's parameter tree
and the port's model, and between their AdamW states, for every arch of
the registry: a reference tree goes to the port and back with the same
leaf set and bit-equal values (gemma2's pairs, the hybrid's [G, P] groups,
shared block and tail, the audio family's encoder and ``dec_layers``, the
MoE ``dense_layers`` and router included)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from _torch_engines import one_thread  # noqa: E402,F401
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import (from_reference_opt_state,  # noqa: E402
                                 from_reference_params, reference_path,
                                 to_reference_opt_state, to_reference_tree)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_reference_tree_round_trip(arch):
    """A reference tree (parameters, and an AdamW state with masters) goes
    into the port and back with the same leaf set and bit-equal values;
    every port parameter has one reference path."""
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    params = jax.jit(lambda k: jinit(k, jc)[0])(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    model = from_reference_params(tree, tc, device="cpu")
    named = dict(model.named_parameters())
    paths = [reference_path(n, tc) for n in named]
    assert len(set(paths)) == len(paths)
    back = _leaves(to_reference_tree(named, tc))
    want = _leaves(tree)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    st = jadamw_init(params, JAdamW(master_weights=True))
    st = jax.tree.map(np.asarray, jax.tree.map(
        lambda a: a + 0.5 if a.dtype == jnp.float32 else a, st))
    port_st = from_reference_opt_state(st, model, device="cpu", cfg=tc)
    assert list(port_st["mu"]) == list(named)
    back, want = _leaves(to_reference_opt_state(port_st, tc)), _leaves(st)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
