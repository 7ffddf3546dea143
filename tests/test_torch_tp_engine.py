"""Tensor-parallel serving of the port against the reference's
single-device engine, on the CPU over gloo: the reference's own dense-GQA
cases (``tests/test_serve_dist.py``: llama3.2-1b at TP 2 and 4
compressed and TP 2 dense, every linear its local rows then an
all-gather; 5 requests, prompt 9, gen [6, 4], 3 slots, max_len 18, block
4), each under ``tp_collective`` 'ring' and 'gspmd', with the weights of
the reference's init (``_torch_tp.check_tp_engine``).  Greedy tokens
equal the reference's on every rank; ``stats()``' ring keys equal the
reference's ``serve_ring_traffic_bytes``, and with compressed weights the
bytes the ring sent per decode step, summed over the ranks, equal that
model.  The other cases are in ``test_torch_tp_families.py``, the CLI
and the refusals in ``test_torch_tp_serve.py``."""

import pytest

from _torch_engines import LLAMA, one_thread  # noqa: F401
from _torch_tp import check_tp_engine

CASES = [(LLAMA, 2, True, "paged"), (LLAMA, 4, True, "paged"),
         (LLAMA, 2, False, "paged")]


@pytest.mark.parametrize("arch,tp,compressed,kv", CASES,
                         ids=[f"{a}-tp{t}-{'comp' if c else 'dense'}-{k}"
                              for a, t, c, k in CASES])
def test_tp_tokens_match_reference_engine(tmp_path, arch, tp, compressed, kv):
    check_tp_engine(tmp_path, arch, tp, compressed, kv)
