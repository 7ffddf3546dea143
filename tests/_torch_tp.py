"""The rank harness of the port's tensor-parallel tests (not a test
module: pytest collects nothing here).

``run_ranks(body, n, out, *argv)`` runs ``body`` (Python source defining
``body(mesh, *argv) -> JSON-able``) on n ranks of a gloo process group on
the CPU: one fresh interpreter (``conftest.run_child``) forks n ranks,
each joins the group over localhost, builds its ``make_serve_mesh(n)`` and
runs ``body`` on one intra-op thread; the ranks' results come back as a
list in rank order.  The child imports torch and the port only; JAX stays
in the test process.  It forks before any torch op has run, so no thread
exists to be copied half-way (``body`` is defined in the child's
``-c`` source, which a spawned rank could not import).

``check_tp_engine(tmp_path, arch, tp, compressed, kv)`` serves the
reference's TP trace on ``tp`` ranks under ``tp_collective`` 'ring' and
'gspmd' and holds every rank to the reference's single-device engine and
traffic model (the cases of ``tests/test_torch_tp_engine.py`` and
``test_torch_tp_families.py``)."""

import numpy as np
import torch

from _torch_engines import DEEPSEEK, pair
from conftest import run_child
from repro.models import serve_ring_traffic_bytes as j_traffic
from repro.serve import ServeEngine as JEngine
from repro.serve import synthetic_trace as jtrace

_RANKS = r'''
import json, sys
import torch
import torch.multiprocessing as mp
from repro_torch.dist.api import free_port, make_serve_mesh


def _rank(rank, n, port, out, argv):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        res = body(make_serve_mesh(n, backend="gloo", device="cpu"), *argv)
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
        dist.barrier()          # no rank tears down while a peer still talks
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    n, out, argv = int(sys.argv[1]), sys.argv[2], sys.argv[3:]
    mp.start_processes(_rank, args=(n, free_port(), out, argv), nprocs=n,
                       start_method="fork")
    print(json.dumps([json.load(open(f"{out}.{r}")) for r in range(n)]))
'''


def run_ranks(body: str, n: int, out, *argv, timeout: int = 300) -> list:
    """``body``'s results on ranks 0..n-1 (``out``: a path prefix for the
    ranks' result files)."""
    return run_child(body + _RANKS, argv=[n, out, *argv], timeout=timeout)


TRACE = dict(n_requests=5, prompt_len=9, gen_lens=[6, 4], seed=0)
STATS = ("tp", "decode_steps", "ring_bytes_per_step",
         "ring_dense_bytes_per_step", "ring_traffic_ratio", "ring_linears",
         "local_linears", "ring_sent_bytes", "gather_sent_bytes",
         "staged_bytes")

_ENGINE = r'''
def body(mesh, model_path, kv, compressed):
    import dataclasses
    from repro_torch.serve import ServeEngine, synthetic_trace
    model, cfg = torch.load(model_path, weights_only=False)
    reqs = synthetic_trace(cfg, n_requests=5, prompt_len=9, gen_lens=[6, 4],
                           seed=0)
    kw = dict(n_slots=3, max_len=18, compressed=compressed == "1", kv=kv)
    if kv == "paged":
        kw.update(block_size=4, debug_invariants=True)
    out = {}
    for coll in ("ring", "gspmd"):
        mesh.reset_stats()
        eng = ServeEngine(model, cfg, mesh=mesh, tp_collective=coll,
                          device="cpu", **kw)
        res = eng.run([dataclasses.replace(r) for r in reqs])
        if eng.pool is not None:
            assert eng.pool.free_blocks == eng.pool.usable_blocks
        st = eng.stats()
        out[coll] = dict(
            tokens={str(rid): r.tokens.tolist() for rid, r in res.items()},
            collective=eng.tp_collective,
            stats={k: st[k] for k in %r if k in st})
    return out
''' % (STATS,)

def check_tp_engine(tmp_path, arch, tp, compressed, kv):
    """Run ``_ENGINE`` on ``tp`` ranks and hold it to the reference's
    single-device engine and traffic model (module docstring of
    ``tests/test_torch_tp_engine.py``)."""
    jc, params, tc, model = pair(arch)
    kw = dict(n_slots=3, max_len=18, compressed=compressed, kv=kv)
    if kv == "paged":
        kw["block_size"] = 4
    ref = JEngine(params, jc, **kw).run(jtrace(jc, **TRACE))
    path = tmp_path / "model.pt"
    torch.save((model, tc), path)
    ranks = run_ranks(_ENGINE, tp, tmp_path / "out", path, kv,
                      "1" if compressed else "0")
    # the reference engine models the tree it serves: the converted one
    mjc, mparams = pair(arch, True)[:2] if compressed else (jc, params)
    want = j_traffic(mparams, mjc, tp)
    for rank, res in enumerate(ranks):
        for coll in ("ring", "gspmd"):
            got = res[coll]
            assert got["collective"] == (coll if compressed else "gspmd")
            assert sorted(map(int, got["tokens"])) == sorted(ref)
            for rid, r in ref.items():
                np.testing.assert_array_equal(
                    got["tokens"][str(rid)], r.tokens,
                    err_msg=f"rank {rank} {coll} rid {rid}")
            st = got["stats"]
            assert st["tp"] == tp
            assert st["ring_bytes_per_step"] == want["ring_bytes"]
            assert st["ring_dense_bytes_per_step"] == \
                want["dense_ring_bytes"]
            assert st["ring_traffic_ratio"] == want["ratio"]
            assert st["ring_linears"] > 0 and st["staged_bytes"] == 0
            if compressed:
                assert st["ring_traffic_ratio"] <= 0.6
    for coll in ("ring", "gspmd"):
        sent = sum(r[coll]["stats"]["ring_sent_bytes"] for r in ranks)
        steps = ranks[0][coll]["stats"]["decode_steps"]
        if coll == "ring" and compressed and arch != DEEPSEEK:
            # every linear of the dense GQA family is compressed and rings
            # in every decode step (prefill runs the local rows); its rows'
            # packed indices fill whole words at these widths
            assert sent == steps * ranks[0][coll]["stats"][
                "ring_bytes_per_step"]
        elif coll == "ring" and compressed:
            # MLA's absorbed wuk / wuv and the expert stacks are modeled
            # (as the reference models them) but not rotated
            assert 0 < sent < steps * ranks[0][coll]["stats"][
                "ring_bytes_per_step"]
        else:
            assert sent == 0
