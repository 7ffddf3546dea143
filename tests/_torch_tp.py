"""The rank harness of the port's tensor-parallel tests (not a test
module: pytest collects nothing here).

``run_ranks(body, n, out, *argv)`` runs ``body`` (Python source defining
``body(mesh, *argv) -> JSON-able``) on n ranks of a gloo process group on
the CPU: one fresh interpreter (without the repo's ``sitecustomize``)
forks n ranks, each joins the group over localhost, builds its
``make_serve_mesh(n)`` and runs ``body`` on one intra-op thread; the
ranks' results come back as a list in rank order.  The child imports
torch and the port only; JAX stays in the test process.  It forks before
any torch op has run, so no thread exists to be copied half-way
(``body`` is defined in the child's ``-c`` source, which a spawned rank
could not import).

``check_tp_engine(tmp_path, arch, tp, compressed, kv)`` serves the
reference's TP trace on ``tp`` ranks under ``tp_collective`` 'ring' and
'gspmd' and holds every rank to the reference's single-device engine and
traffic model (the cases of ``tests/test_torch_tp_engine.py``,
``test_torch_tp_families.py`` and ``test_torch_tp_state_families.py``).
``BLOCKS`` is the body of the block-operation cases: a shared-prefix
trace through a small pool with the prefix cache and suspend on, served
over the mesh and on one rank."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from _torch_engines import pair
from conftest import SRC
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
    ranks' result files).  The child finds the port through its own
    ``sys.path``, not ``PYTHONPATH``: the repo's ``sitecustomize`` would
    import JAX in it, seconds of start-up the child never uses."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in env.get("PYTHONPATH", "").split(os.pathsep)
        if p and os.path.abspath(p) != SRC)
    code = f"import sys\nsys.path.insert(0, {SRC!r})\n" + body + _RANKS
    res = subprocess.run([sys.executable, "-c", code,
                          *map(str, (n, out, *argv))],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


TRACE = dict(n_requests=5, prompt_len=9, gen_lens=[6, 4], seed=0)
STATS = ("tp", "decode_steps", "ring_bytes_per_step",
         "ring_dense_bytes_per_step", "ring_traffic_ratio", "ring_linears",
         "local_linears", "ring_tick_bytes", "ring_sent_bytes",
         "gather_sent_bytes", "staged_bytes")

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
    tick = ref_tick_bytes(mjc, mparams, tp) if compressed else 0
    for coll in ("ring", "gspmd"):
        # the ring sends, over both ranks, what the model of a decode tick
        # says in every decode step (prefill runs the local rows), and the
        # port's model of a tick is the reference's; its rows' packed
        # indices fill whole words at these widths
        st = ranks[0][coll]["stats"]
        if coll == "gspmd":
            assert st["ring_tick_bytes"] == 0
        elif tick is None:
            assert 0 < st["ring_tick_bytes"] < want["ring_bytes"]
        else:
            assert st["ring_tick_bytes"] == tick
        sent = sum(r[coll]["stats"]["ring_sent_bytes"] for r in ranks)
        assert sent == st["decode_steps"] * st["ring_tick_bytes"]
        assert (sent > 0) == (coll == "ring" and compressed)


def _compressed(tree):
    """The compressed linears of a reference tree (the ring rotates no
    other: a dense linear runs its local rows and all-gathers them)."""
    if not isinstance(tree, dict) or "w_vals" in tree:
        return tree if isinstance(tree, dict) else {}
    return {k: _compressed(v) for k, v in tree.items()}


def ref_tick_bytes(jc, params, tp):
    """The bytes one decode tick's ring sends by the reference's model
    (``serve_ring_traffic_bytes`` of the reference's compressed linears,
    which counts each stored linear once): the hybrid's shared block once
    more for each further group, less the audio family's encoder and
    cross ``wk`` / ``wv`` (run in prefill only; a tick reads the cached
    cross K/V).  None under MLA, whose absorbed ``wuk`` / ``wuv`` and
    expert stacks the model counts but the tick does not rotate."""
    if jc.mla:
        return None

    def ring(tree):
        return j_traffic(tree, jc, tp)["ring_bytes"]
    params = _compressed(params)
    tick = ring(params)
    if jc.family == "hybrid":
        tick += (jc.n_layers // jc.attn_period - 1) * ring(params["shared"])
    if jc.family == "audio":
        cross = params["dec_layers"]["cross"]
        tick -= ring(params["enc_layers"]) + ring(
            {"wk": cross["wk"], "wv": cross["wv"]})
    return tick


BLOCKS = r'''
def body(mesh, model_path):
    import dataclasses
    from repro_torch.serve import ServeEngine, shared_prefix_trace
    model, cfg = torch.load(model_path, weights_only=False)
    reqs = shared_prefix_trace(cfg, n_requests=6, prefix_len=12,
                               suffix_len=4, gen_lens=[6, 4], seed=0,
                               n_prefixes=2)
    kw = dict(n_slots=3, max_len=24, compressed=True, kv="paged",
              block_size=4, n_blocks=10, prefix_cache=True,
              preempt="suspend", debug_invariants=True, device="cpu")
    out = {}
    for name, m in (("tp", mesh), ("one", None)):
        eng = ServeEngine(model, cfg, mesh=m, **kw)
        res = eng.run([dataclasses.replace(r) for r in reqs])
        eng.check_invariants()
        st = eng.stats()
        out[name] = dict(
            tokens={str(k): v.tokens.tolist() for k, v in res.items()},
            stats={k: st[k] for k in ("prefix_hits", "cow_copies",
                                      "swap_outs", "swap_ins",
                                      "preemptions", "decode_steps")})
    return out
'''
