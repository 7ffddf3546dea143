"""Tensor-parallel serving and "model"-axis training of the families with
windows, state, an encoder or embedding prompts (gemma2-9b,
falcon-mamba-7b, zamba2-7b, whisper-small, qwen2-vl-7b) against the
reference, at smoke size on gloo ranks on the CPU.

* Serving at TP 2, compressed and paged, under 'ring' and 'gspmd'
  (``_torch_tp.check_tp_engine``): every rank's greedy tokens bit-equal
  to the reference's single-device engine, its ``ring_bytes_per_step``
  the reference's ``serve_ring_traffic_bytes``, and the ring's sends over
  both ranks the model of a decode tick (``models.decode_ring_bytes``),
  which equals the reference's model of the linears a tick runs
  (``_torch_tp.ref_tick_bytes``).
  Then falcon's slotted engine at TP 2, and zamba2's pool with the prefix
  cache and suspend on (no hit: its state is slot-indexed; its blocks and
  state rows are swapped on shards) against the single-device engine.
* The cache specs of every arch of the registry against the reference's
  (``init_caches``' spec tree), and the paged pool's leaves on each rank
  the shards of the reference pool's under its resolved specs.
* One ``make_train_step`` step on a (1, 2) mesh, the "model" axis alone,
  for each of the five, whisper under ``DEFAULT_RULES`` (its own
  ``"fulldp"`` splits no weight): the global loss within 1e-5 relative
  and the gathered parameters and AdamW moments within 1e-4 of the
  reference's unsharded ``make_train_step`` (the sharded-training
  gates), the gradient norm within 1e-5 of the port's one-process
  step."""

import pytest
import torch

from _torch_dist import (close_to_reference, port_step, ref_step,
                         train_on_ranks)
from _torch_engines import one_thread, pair  # noqa: F401
from _torch_tp import BLOCKS, check_tp_engine, run_ranks
from repro.configs import get_config as jget
from repro.dist.api import SERVE_TP_RULES as JRULES
from repro.dist.api import logical_to_pspec
from repro.models import init_caches as jinit_caches
from repro.serve.paged import BlockPool as JPool
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.dist.api import ServeMesh
from repro_torch.models import init_caches
from repro_torch.models.transformer import cache_specs
from repro_torch.serve.paged import BlockPool

ARCHS = ("gemma2-9b", "falcon-mamba-7b", "zamba2-7b", "whisper-small",
         "qwen2-vl-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_tokens_match_reference_engine(tmp_path, arch):
    check_tp_engine(tmp_path, arch, 2, True, "paged")


def test_slotted_ssm_tp_matches_reference_engine(tmp_path):
    check_tp_engine(tmp_path, "falcon-mamba-7b", 2, True, "slotted")


def test_zamba2_suspend_on_shards(tmp_path):
    """zamba2 through a 10-block pool with the prefix cache and suspend
    on: the TP 2 engine's tokens and counters equal the single-device
    engine's (whose are held to the reference's in
    ``test_torch_ssm_serve.py``); requests are suspended (their blocks
    and Mamba2 state rows swapped) and none hits the prefix cache."""
    _, _, tc, model = pair("zamba2-7b")
    path = tmp_path / "model.pt"
    torch.save((model, tc), path)
    for res in run_ranks(BLOCKS, 2, tmp_path / "out", path):
        assert res["tp"] == res["one"]
        st = res["tp"]["stats"]
        assert st["swap_outs"] > 0 and st["prefix_hits"] == 0, st


def _logical(tree):
    if isinstance(tree, dict):
        return {k: _logical(v) for k, v in tree.items()}
    return tuple(None if e == "stack" else e for e in tree)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


class _Stand:
    shape = {"model": 2}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_reference(arch):
    """The port's ``cache_specs`` of the slotted caches are the
    reference's spec tree (its "stack" axes are the port's None), and each
    leaf of ``BlockPool(mesh=)`` on each of 2 ranks has the shape of that
    rank's shard of the reference pool's leaf."""
    jc, tc = jget(arch, smoke=True), get_config(arch, smoke=True)
    jcaches, jspecs = jinit_caches(jc, 2, 16)
    tcaches = init_caches(tc, 2, 16, device="meta")
    assert cache_specs(tcaches) == _logical(jspecs)
    assert _shapes(tcaches) == _shapes(jcaches)
    ref = JPool(jc, n_slots=2, max_len=16, block_size=4)
    want, specs = _shapes(ref.caches), ref.cache_specs
    if "local" in want:
        # the port's pool keeps gemma2's local and global layers in one
        # [L, ...] stack, the window a read mask (``serve.paged``)
        want = {f: (2 * shape[0],) + shape[1:]
                for f, shape in want["global"].items()}
        specs = specs["global"]
    for rank in range(2):
        mesh = ServeMesh(size=2, rank=rank, device=torch.device("cpu"),
                         backend="gloo")
        got = _shapes(BlockPool(tc, 2, 16, 4, device="cpu",
                                mesh=mesh).caches)
        assert got == _sharded(want, specs)


def _sharded(shapes, specs):
    """The shapes of a rank's shards of a tree of ``shapes`` under the
    reference's logical ``specs``, resolved on a 2-rank "model" axis."""
    if isinstance(shapes, dict):
        return {k: _sharded(v, specs[k]) for k, v in shapes.items()}
    pspec = logical_to_pspec(specs, JRULES, mesh=_Stand(), shape=shapes)
    return tuple(d // 2 if i < len(pspec) and pspec[i] is not None else d
                 for i, d in enumerate(shapes))


JOBS = [dict(arch=arch, shape=(1, 2), accum=1, pregather=False,
             **({"rules": "default"} if arch == "whisper-small" else {}))
        for arch in ARCHS]


@pytest.fixture(scope="module")
def model_axis(tmp_path_factory):
    """``JOBS`` on 2 ranks, one child for all five."""
    return train_on_ranks(tmp_path_factory.mktemp("model_axis"), 2, JOBS)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_step_matches_reference(model_axis, arch):
    ranks, trees = model_axis
    i = ARCHS.index(arch)
    loss, gnorm = port_step(arch, 1)
    jloss = ref_step(arch, 1)[0]
    for rank in ranks:
        got = rank[i]
        assert got["loss"] == pytest.approx(jloss, rel=1e-5)
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        assert got["gnorm"] == pytest.approx(gnorm, rel=1e-5)
        # no FSDP at data = 1: the model axis's gathers and dX all-reduces
        st = got["stats"]
        assert st["fsdp_gather_bytes"] == st["fsdp_scatter_bytes"] == 0
        assert st["gather_bytes"] > 0 and st["reduce_bytes"] > 0
    close_to_reference(arch, trees[i], *ref_step(arch, 1)[2:])
