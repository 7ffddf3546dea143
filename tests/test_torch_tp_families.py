"""Tensor-parallel serving against the reference's single-device engine,
the rest of the reference's cases (``tests/test_serve_dist.py``):
deepseek-v2-lite-16b at TP 2 (MLA attention over a replicated latent
pool, heads split; the MoE router's experts and the expert stacks' rows
split) and deepseek-67b at TP 2, each under 'ring' and 'gspmd'
(``_torch_tp.check_tp_engine``); the slotted engine's case is in
``test_torch_tp_serve.py``.  Then the pool's block operations on shards:
prefix sharing (``share``, ``cow``) and suspend (``swap_out`` /
``swap_in``) under a mesh give the single-device engine's tokens and
counters."""

import pytest
import torch

from _torch_engines import DEEPSEEK, LLAMA, one_thread, pair  # noqa: F401
from _torch_tp import BLOCKS, check_tp_engine, run_ranks

CASES = [(DEEPSEEK, 2, True, "paged"), ("deepseek-67b", 2, True, "paged")]


@pytest.mark.parametrize("arch,tp,compressed,kv", CASES,
                         ids=[f"{a}-tp{t}-{'comp' if c else 'dense'}-{k}"
                              for a, t, c, k in CASES])
def test_tp_tokens_match_reference_engine(tmp_path, arch, tp, compressed, kv):
    check_tp_engine(tmp_path, arch, tp, compressed, kv)


def test_prefix_and_suspend_on_shards(tmp_path):
    """A shared-prefix trace through a 10-block pool with the prefix cache
    and suspend on: the TP 2 engine's tokens and block counters equal the
    single-device engine's (whose are held to the reference's in
    ``test_torch_prefix.py``), and the trace does hit and swap."""
    _, _, tc, model = pair(LLAMA)
    path = tmp_path / "model.pt"
    torch.save((model, tc), path)
    for res in run_ranks(BLOCKS, 2, tmp_path / "out", path):
        assert res["tp"] == res["one"]
        st = res["tp"]["stats"]
        assert st["prefix_hits"] > 0 and st["swap_outs"] > 0, st
