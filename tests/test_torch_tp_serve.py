"""The slotted engine, the CLI and the refusals under tensor-parallel
serving: the slotted engine at TP 2 (its cache rows' kv heads split)
against the reference's single-device one, the last of the reference's
cases (``_torch_tp.check_tp_engine``); ``--tp 2 --device cpu`` gives the
tokens of ``--tp 0``; a mesh of one rank serves the plain engine's
tokens; the other families, ``spec=``, an unknown collective, CUDA
graphs over gloo's host staging, a wider mesh without its processes,
NCCL on the CPU, a sharded linear outside its mesh, and the CLI's
``--tp`` with the sequential scheduler, with ``--spec`` or with a mesh of
more than one axis, all raise."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_engines import LLAMA, one_thread, pair  # noqa: F401
from _torch_tp import TRACE, check_tp_engine
from conftest import child_env
from repro_torch.dist.api import ServeMesh, make_serve_mesh
from repro_torch.serve import ServeEngine, SpecConfig


def test_slotted_tp_matches_reference_engine(tmp_path):
    check_tp_engine(tmp_path, LLAMA, 2, True, "slotted")


def _cli(*args):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LLAMA,
         "--smoke", "--scheduler", "continuous", "--kv", "paged",
         "--device", "cpu", "--slots", "3", "--requests", "5",
         "--prompt-len", "9", "--gen", "6", *args],
        capture_output=True, text=True, env=child_env(1), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_cli_tp_gives_the_single_device_tokens():
    """``--tp 2 --device cpu`` (two ranks it starts itself, gloo) prints
    the token count and sample of ``--tp 0``, plus its ring line."""
    one, two = _cli("--tp", "0"), _cli("--tp", "2")

    def key(out):
        lines = out.splitlines()
        count = next(line for line in lines if line.startswith(
            "continuous[")).split(" tokens in ")[0].split(": ")[-1]
        steps = next(line for line in lines if " decode steps" in line)
        steps = steps.split(" tokens in ")[1].split(" decode steps")[0]
        return count, steps, next(line for line in lines
                                  if line.startswith("sample:"))

    assert key(one) == key(two)
    assert "tp[2 ranks, gloo, ring]" in two and "tp[" not in one


def _mesh(device="cpu", size=2):
    return ServeMesh(size=size, rank=0, device=torch.device(device),
                     backend="gloo")


@pytest.mark.parametrize("arch", ["gemma2-9b", "falcon-mamba-7b",
                                  "zamba2-7b", "whisper-small",
                                  "qwen2-vl-7b"])
def test_other_families_raise_under_a_mesh(arch):
    from repro_torch.configs import get_config
    with pytest.raises(NotImplementedError, match="distribution"):
        ServeEngine(None, get_config(arch, smoke=True), 2, 16, kv="paged",
                    mesh=_mesh(), device="cpu")


def test_engine_refusals_under_a_mesh():
    """spec= under a mesh, an unknown tp_collective, a mesh on another
    device type, and CUDA graphs over gloo's host staging all raise."""
    _, _, tc, model = pair(LLAMA)
    kw = dict(n_slots=2, max_len=16, kv="paged", device="cpu")
    with pytest.raises(ValueError, match="spec= over a mesh"):
        ServeEngine(model, tc, mesh=_mesh(), spec=SpecConfig(k=2),
                    compressed=True, **kw)
    with pytest.raises(ValueError, match="tp_collective"):
        ServeEngine(model, tc, mesh=_mesh(), tp_collective="allgather", **kw)
    with pytest.raises(ValueError, match="mesh's rank runs on"):
        ServeEngine(model, tc, mesh=_mesh("cuda"), **kw)
    with pytest.raises(ValueError, match="gloo"):
        ServeEngine(model, tc, mesh=_mesh("cuda"),
                    **dict(kw, device="cuda"), graphs=True)


def test_mesh_and_shard_refusals():
    """A wider mesh without its processes, NCCL on the CPU, and a sharded
    linear used outside its mesh's context raise; nothing runs as one
    rank in silence."""
    from repro_torch.core.layers import linear_apply
    from repro_torch.models import shard_model
    with pytest.raises(ValueError, match="processes"):
        make_serve_mesh(2, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        make_serve_mesh(1, backend="nccl", device="cpu")
    _, _, tc, model = pair(LLAMA)
    local = shard_model(model, _mesh())
    lin = local.layers[0].attn.wq
    x = torch.zeros(1, 1, tc.d_model)
    with pytest.raises(RuntimeError, match="axis_rules"):
        linear_apply(lin, x, tc.sparsity)


@pytest.mark.parametrize("args,what", [
    (["--tp", "2"], "--scheduler continuous"),
    (["--tp", "2", "--scheduler", "continuous", "--kv", "paged", "--spec"],
     "--spec does not support"),
    (["--mesh", "data=2,model=2", "--scheduler", "continuous"],
     "one axis"),
])
def test_cli_refusals(capsys, args, what):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=what):
        serve.main(["--arch", LLAMA, "--smoke", "--device", "cpu", *args])


def test_tp1_mesh_equals_the_plain_engine():
    """A mesh of one rank (gloo, started in this process) serves the
    tokens of the engine without one: every linear is its own whole
    shard, every gather a copy."""
    import torch.distributed as dist
    _, _, tc, model = pair(LLAMA)
    from repro_torch.serve import synthetic_trace
    reqs = synthetic_trace(tc, **TRACE)
    kw = dict(n_slots=3, max_len=18, compressed=True, kv="paged",
              block_size=4, device="cpu")
    mesh = make_serve_mesh(1, backend="gloo", device="cpu")
    try:
        got = ServeEngine(model, tc, mesh=mesh, **kw).run(
            [dataclasses.replace(r) for r in reqs])
    finally:
        dist.destroy_process_group()
    want = ServeEngine(model, tc, **kw).run(
        [dataclasses.replace(r) for r in reqs])
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
