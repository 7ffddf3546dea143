"""Sharded SR-STE training of the port against the reference's unsharded
step, at smoke size in f32 on gloo ranks on the CPU.

``make_shardings`` on the 2-D (and pod) meshes and ``batch_specs`` equal
the reference's.  One ``make_train_step`` step on a (data, model) mesh of
4 ranks, (2, 2) and (4, 1), and of 2 ranks, (1, 2), for llama and for
the deepseek smoke config (an MLA dense layer, an MoE layer whose
capacity drops tokens): the global loss within 1e-5 relative and the
gathered parameters and AdamW moments within 1e-4 of the reference's
``make_train_step``, the gradient norm within 1e-5 of the port's
one-process step.  Each rank holds 1 / data of the moments, exactly.
``pregather_fsdp`` against the standard step at accumulation depths 2
and 4: the loss within 1e-4 relative and the parameters within 1e-3
(the reference's own ``test_pregather.py`` gates); the FSDP gather and
reduce-scatter bytes equal their model from the shapes, once a step
under pregather and once a microbatch without."""

import itertools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import (close_to_reference, port_step, ref_step,  # noqa: E402
                         train_on_ranks, whole_bytes)
from _torch_engines import DEEPSEEK, LLAMA, one_thread, pair  # noqa: E402,F401
from repro.data.pipeline import batch_specs as jbatch_specs  # noqa: E402
from repro.dist import api as japi  # noqa: E402
from repro.launch.steps import abstract_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import batch_specs  # noqa: E402
from repro_torch.dist import api  # noqa: E402
import repro_torch.models.ffn as ffn_mod  # noqa: E402

ARCHS = (LLAMA, DEEPSEEK)


class _Mesh:
    """A stand-in mesh: what the resolution reads."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _abstract(shape):
    names = tuple(shape)
    try:
        return jax.sharding.AbstractMesh(tuple(shape.items()))
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(shape.values()), names)


def _entries(p):
    out = list(p)
    while out and out[-1] is None:
        out.pop()
    return tuple(tuple(e) if isinstance(e, list) else e for e in out)


@pytest.mark.parametrize("shape", [dict(data=2, model=2),
                                   dict(data=4, model=1),
                                   dict(data=1, model=2),
                                   dict(data=2, model=4),
                                   dict(pod=2, data=2, model=2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_shardings_2d_match_reference(arch, shape):
    """The reference's own spec tree and shapes of ``arch`` (smoke) through
    the port's ``make_shardings`` on a (pod,) data x model mesh: every
    resolved spec is the reference's ``NamedSharding``'s."""
    jc = get_config(arch, smoke=True)
    from repro.configs import get_config as jget
    shapes, specs, _ = abstract_params(jget(arch, smoke=True))
    want = japi.make_shardings(specs, _abstract(shape), shapes_tree=shapes)
    got = api.make_shardings(specs, _Mesh(**shape), shapes_tree=shapes)
    wl = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    gl = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, api.Sharding))
    assert len(wl) == len(gl) > 0 and jc.name == arch
    for (pw, w), (pg, g) in zip(wl, gl):
        assert jax.tree_util.keystr(pw) == jax.tree_util.keystr(pg)
        assert g.spec == _entries(w.spec), jax.tree_util.keystr(pw)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b",
                                  "falcon-mamba-7b", "whisper-small",
                                  "qwen2-vl-7b"])
def test_batch_specs_match_reference(arch):
    from repro.configs import get_config as jget
    assert batch_specs(get_config(arch, smoke=True), 8, 16) == \
        jbatch_specs(jget(arch, smoke=True), 8, 16)


FOUR = [dict(arch=arch, shape=shape, accum=1, pregather=False)
        for arch in ARCHS for shape in ((2, 2), (4, 1))] + [
    dict(arch=LLAMA, shape=(2, 2), accum=a, pregather=p)
    for a, p in itertools.product((2, 4), (False, True))]
TWO = [dict(arch=arch, shape=(1, 2), accum=1, pregather=False)
       for arch in ARCHS]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """``FOUR`` on 4 ranks: llama and deepseek on (2, 2) and (4, 1), and
    llama's standard and pregather steps at accumulation depths 2 and 4
    on (2, 2)."""
    return train_on_ranks(tmp_path_factory.mktemp("four"), 4, FOUR)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """``TWO`` on 2 ranks, (1, 2): the "model" axis alone."""
    return train_on_ranks(tmp_path_factory.mktemp("two"), 2, TWO)


def _check_job(job, ranks, tree, i, reference=True):
    arch = job["arch"]
    loss, gnorm = port_step(arch, job["accum"])
    for rank in ranks:
        got = rank[i]
        assert got["loss"] == pytest.approx(loss, rel=1e-5), job
        assert got["gnorm"] == pytest.approx(gnorm, rel=1e-5), job
    if reference:
        jloss, _, jp, jmu, jnu = ref_step(arch, job["accum"])
        for rank in ranks:
            assert rank[i]["loss"] == pytest.approx(jloss, rel=1e-5), job
        close_to_reference(arch, tree, jp, jmu, jnu)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_on_four_ranks(four_ranks, arch, shape):
    ranks, trees = four_ranks
    i = FOUR.index(dict(arch=arch, shape=shape, accum=1, pregather=False))
    _check_job(FOUR[i], ranks, trees[i], i)
    # each rank holds its shard of the f32 moments: 1 / data of every
    # leaf (exactly, at (4, 1)), 1 / (data x model) of the split rows
    for rank in ranks:
        if shape == (4, 1):
            assert rank[i]["state_bytes"] * 4 == whole_bytes(arch)
        else:
            assert rank[i]["state_bytes"] * 2 < whole_bytes(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_on_the_model_axis(two_ranks, arch):
    ranks, trees = two_ranks
    i = TWO.index(dict(arch=arch, shape=(1, 2), accum=1, pregather=False))
    _check_job(TWO[i], ranks, trees[i], i)
    st = ranks[0][i]["stats"]
    # no FSDP at data = 1: the model axis's gathers and dX all-reduces
    assert st["fsdp_gather_bytes"] == st["fsdp_scatter_bytes"] == 0
    assert st["gather_bytes"] > 0 and st["reduce_bytes"] > 0


def test_deepseek_smoke_step_drops_tokens(monkeypatch):
    """The deepseek smoke step's MoE layer drops assignments past its
    capacity (the sharded runs above route over the global batch)."""
    from _torch_dist import batch
    from repro_torch.data import to_device
    from repro_torch.models import loss_fn
    _, _, tc, model = pair(DEEPSEEK)
    seen = []
    real = ffn_mod.expert_counts

    def counting(ids, e):
        counts = real(ids, e)
        seen.append(counts)
        return counts

    monkeypatch.setattr(ffn_mod, "expert_counts", counting)
    with torch.no_grad():
        loss_fn(model, tc, to_device(batch(tc), "cpu"))
    t = 8 * 16
    cap = ffn_mod._capacity(t, tc.n_experts, tc.top_k, tc.capacity_factor)
    assert seen and sum(int(torch.clamp(c - cap, min=0).sum())
                        for c in seen) > 0


@pytest.mark.parametrize("accum", [2, 4])
def test_pregather_equals_standard(four_ranks, accum):
    """pregather against standard on (2, 2) (the reference's gates), both
    against the port's one-process step at the same depth; the FSDP
    bytes: standard = accum x pregather, each the model's."""
    ranks, trees = four_ranks
    std = FOUR.index(dict(arch=LLAMA, shape=(2, 2), accum=accum,
                          pregather=False))
    pre = FOUR.index(dict(arch=LLAMA, shape=(2, 2), accum=accum,
                          pregather=True))
    for rank in ranks:
        assert rank[pre]["loss"] == pytest.approx(rank[std]["loss"],
                                                  rel=1e-4)
        s, p = rank[std]["stats"], rank[pre]["stats"]
        model = rank[pre]["fsdp_model"]
        assert p["fsdp_gather_bytes"] == model > 0
        assert s["fsdp_gather_bytes"] == accum * model
        # the gradients travel as f32; the model is f32 here
        assert p["fsdp_scatter_bytes"] == model
        assert s["fsdp_scatter_bytes"] == accum * model
    for name, got in trees[pre]["params"].items():
        np.testing.assert_allclose(got.numpy(),
                                   trees[std]["params"][name].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    _check_job(FOUR[pre], ranks, trees[pre], pre, reference=False)
    _check_job(FOUR[std], ranks, trees[std], std, reference=False)


def test_pregather_bytes_independent_of_accum(four_ranks):
    ranks, _ = four_ranks
    got = {a: ranks[0][FOUR.index(dict(arch=LLAMA, shape=(2, 2), accum=a,
                                       pregather=True))]["stats"]
           for a in (2, 4)}
    assert got[2]["fsdp_gather_bytes"] == got[4]["fsdp_gather_bytes"]
    assert got[2]["fsdp_scatter_bytes"] == got[4]["fsdp_scatter_bytes"]


@pytest.mark.parametrize("accum", [1, 2, 4])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 2)])
def test_local_batch_takes_each_microbatch_part(shape, accum):
    """A rank's rows: its part of each global microbatch, in microbatch
    order, so the step's split into ``accum`` chunks is its part of each
    (the data ranks together hold every row once; model ranks agree)."""
    from repro_torch.data import local_batch
    rows = 16
    batch = {"tokens": np.arange(rows * 3).reshape(rows, 3)}
    got = {}
    for rank in range(shape[0] * shape[1]):
        mesh = api.TrainMesh(("data", "model"), shape, rank,
                             torch.device("cpu"), "gloo", {})
        with api.axis_rules(mesh):
            got[rank] = local_batch(batch, accum)["tokens"]
    n, mb = shape[0], rows // accum
    for rank, part in got.items():
        d = rank // shape[1]
        want = np.concatenate([batch["tokens"][i * mb + d * mb // n:
                                               i * mb + (d + 1) * mb // n]
                               for i in range(accum)])
        np.testing.assert_array_equal(part, want)


@pytest.mark.parametrize("accum,batch,ranks,want", [
    (4, 8, 1, 4), (4, 8, 2, 4), (4, 8, 4, 2), (4, 8, 8, 1), (2, 8, 2, 2),
    (3, 8, 2, 2), (1, 8, 4, 1), (4, 6, 2, 3)])
def test_accum_clamp(accum, batch, ranks, want):
    """The reference launcher's clamp, min(accum, batch // ranks), stepped
    down to a depth whose microbatch divides over the batch ranks."""
    from repro_torch.data import accum_for_mesh
    assert accum_for_mesh(accum, batch, ranks) == want
