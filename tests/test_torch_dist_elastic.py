"""Elastic mesh planning and resume of the port's sharded training
against the reference and the port's one-process loop, on gloo ranks on
the CPU.

``_best_model_axis`` / ``degraded_meshes`` equal the reference's over a
grid of (ndev, losses, prefer_model).  ``train_loop(use_mesh=True)``
saves under (2, 2) on 4 ranks and resumes under (1, 2) on 2 ranks: the
resumed losses within 1e-4 of an uninterrupted one-process run, and the
checkpoint, written whole by rank 0, equal to an unsharded run's leaf
for leaf.  whisper trains under its ``"fulldp"`` layout (weights
replicated, the batch over the whole mesh) as in one process; every
family's model is cut for a "model" axis of 1 and 2 along its rows
only."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engines import LLAMA, one_thread  # noqa: E402,F401
from _torch_tp import run_ranks  # noqa: E402
from repro.dist import api as japi  # noqa: E402
from repro.dist import elastic as jelastic  # noqa: E402
from repro_torch.dist import api  # noqa: E402
from repro_torch.dist import elastic  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_model, shard_for_training  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402

LOOP = dict(smoke=True, batch=8, seq=16, n_layers=2, log_every=100,
            device="cpu")
WHISPER = "whisper-small"


@pytest.mark.parametrize("prefer", [1, 2, 4, 8])
@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 6, 8, 12, 16])
def test_degraded_meshes_match_reference(ndev, prefer):
    losses = list(range(0, ndev + 2))
    assert elastic._best_model_axis(ndev, prefer) == \
        jelastic._best_model_axis(ndev, prefer)
    assert elastic.degraded_meshes(ndev, losses, prefer) == \
        [(n, tuple(m)) for n, m in jelastic.degraded_meshes(ndev, losses,
                                                           prefer)]


_BODY = r'''
def body(mesh, ck, phase):
    from repro_torch.dist.api import make_train_mesh
    from repro_torch.launch.train import train_loop
    loop = dict(smoke=True, batch=8, seq=16, n_layers=2, log_every=100,
                device="cpu", use_mesh=True)
    out = {}
    if phase == "save":
        run = train_loop("llama3.2-1b", steps=2, ckpt_dir=ck, ckpt_every=100,
                         mesh=make_train_mesh((2, 2), device="cpu"), **loop)
        out["llama"] = run.losses
        tm = make_train_mesh((2, 2), device="cpu")
        run = train_loop("whisper-small", steps=1, ckpt_dir="",
                         mesh=tm, enc_layers=1, **loop)
        out["whisper"] = dict(
            loss=run.losses, gnorm=run.gnorms, accum=run.accum,
            shard=sum(p.numel() for p in run.model.parameters()),
            fsdp=tm.stats["fsdp_gather_bytes"])
    else:
        run = train_loop("llama3.2-1b", steps=4, ckpt_dir=ck, ckpt_every=100,
                         mesh=make_train_mesh((1, 2), device="cpu"), **loop)
        out["llama"] = run.losses
    return out
'''


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    ck = tmp / "ck"
    saved = run_ranks(_BODY, 4, tmp / "a", ck, "save")
    steps = sorted(os.listdir(ck))
    resumed = run_ranks(_BODY, 2, tmp / "b", ck, "resume")
    one = tmp / "one"
    unsharded = train_loop(LLAMA, steps=2, ckpt_dir=str(one),
                           ckpt_every=100, **LOOP)
    whole = train_loop(LLAMA, steps=4, ckpt_dir="", **LOOP)
    return dict(saved=saved, steps=steps, resumed=resumed, ck=ck, one=one,
                unsharded=unsharded, whole=whole)


def test_resume_under_a_smaller_mesh(elastic_runs):
    r = elastic_runs
    assert r["steps"] == ["step_0000000002"]
    for rank in r["saved"]:
        np.testing.assert_allclose(rank["llama"], r["whole"].losses[:2],
                                   rtol=1e-4, atol=1e-4)
    for rank in r["resumed"]:
        np.testing.assert_allclose(rank["llama"], r["whole"].losses[2:],
                                   rtol=1e-4, atol=1e-4)
    assert sorted(os.listdir(r["ck"])) == ["step_0000000002",
                                           "step_0000000004"]


def test_checkpoint_equals_an_unsharded_run(elastic_runs):
    """The sharded run's checkpoint (rank 0, gathered whole) against the
    one-process run's: the same leaves, the same shapes, values within
    1e-5, and the data cursor."""
    import json
    r = elastic_runs
    sub = "step_0000000002"
    with np.load(r["ck"] / sub / "host0.npz") as a, \
            np.load(r["one"] / sub / "host0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    for d in (r["ck"], r["one"]):
        with open(d / sub / "meta.json") as f:
            assert json.load(f) == {"step": 2, "data_state": 2}


def test_whisper_trains_fulldp(elastic_runs):
    """whisper's ``"fulldp"``: every rank holds the whole model, the batch
    splits over data x model (4 ranks), no FSDP gather; the loss and
    gradient norm are the one-process loop's."""
    one = train_loop(WHISPER, steps=1, ckpt_dir="", enc_layers=1, **LOOP)
    n_params = sum(p.numel() for p in one.model.parameters())
    for rank in elastic_runs["saved"]:
        w = rank["whisper"]
        assert w["shard"] == n_params and w["fsdp"] == 0
        assert w["loss"][0] == pytest.approx(one.losses[0], rel=1e-5)
        assert w["gnorm"][0] == pytest.approx(one.gnorms[0], rel=1e-5)


def test_fulldp_rules_are_the_dry_runs():
    """The rules of ``train_rules_for`` under "fulldp": the reference
    dry-run's replacement of the default table."""
    cfg = get_config(WHISPER, smoke=True)
    assert cfg.train_layout == "fulldp"
    for mesh in (_Mesh(data=2, model=2), _Mesh(pod=2, data=2, model=2)):
        want = dict(japi.MULTIPOD_RULES if "pod" in mesh.shape
                    else japi.DEFAULT_RULES)
        want.update(act_batch=(("pod", "data", "model") if "pod" in
                               mesh.shape else ("data", "model")),
                    fsdp=None, tp=None, act_heads=None, act_vocab=None,
                    act_seq_sp=None, act_ep=None)
        assert api.train_rules_for(cfg, mesh) == want
    assert api.train_rules_for(get_config(LLAMA, smoke=True),
                               _Mesh(data=2, model=2)) == api.DEFAULT_RULES


class _Mesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)

    def coord(self, axis):
        return 0


# the leaves a "model" axis may split, and the dimension it splits
_ROWS = {"w": -2, "w_vals": -2, "w_idx": -2, "mask": -2, "emb": 0, "b": -1}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b",
                                  "gemma2-9b", "falcon-mamba-7b",
                                  "zamba2-7b", "whisper-small",
                                  "qwen2-vl-7b"])
@pytest.mark.parametrize("model", [1, 2])
def test_model_axis_refusal(arch, model):
    """No family is refused a "model" axis: at model 1 and 2, under
    ``DEFAULT_RULES`` and the config's own rules, ``shard_for_training``
    cuts every family's model with "model" splitting a linear's rows,
    a bias or the embedding's vocab and nothing else (the mixers' f32
    leaves, norms, the router stay whole over it); every rule set but
    whisper's ``"fulldp"`` puts the rows on it."""
    cfg = get_config(arch, smoke=True)
    whole = init_model(cfg, device="meta")
    ndim = {name: t.dim() for name, t in list(whole.named_parameters())
            + list(whole.named_buffers())}
    mesh = _Mesh(data=2, model=model)
    for rules in (api.DEFAULT_RULES, api.train_rules_for(cfg, mesh)):
        with api.axis_rules(mesh, rules):
            _, layouts = shard_for_training(whole, mesh)
        split = {name: [d for d, e in enumerate(lay.spec)
                        if e is not None and "model" in
                        (e if isinstance(e, tuple) else (e,))]
                 for name, lay in layouts.items()}
        split = {name: dims for name, dims in split.items() if dims}
        for name, dims in split.items():
            leaf = name.rsplit(".", 1)[-1]
            assert leaf in _ROWS, (name, dims)
            assert dims == [_ROWS[leaf] % ndim[name]], (name, dims)
        assert bool(split) == (rules["tp"] is not None), (rules, split)
