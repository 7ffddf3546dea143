"""Pipeline parallelism demo (the GPipe schedule of ``dist.pipeline``).

Starts S ranks of a localhost process group (4 on the CPU over gloo, 2 on
the card: several ranks share one card over gloo, staged through host
memory), splits an 8-layer tanh MLP into S stages and streams 8
microbatches through, checked against the sequential model.

  PYTHONPATH=src python -m repro_torch.examples.pipeline_parallel
  PYTHONPATH=src python -m repro_torch.examples.pipeline_parallel --device cuda
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

M, MB, D, LAYERS = 8, 4, 64, 8


def _model(n_stages: int):
    """(stacked stage weights [S, LAYERS / S, D, D], inputs [M, MB, D]),
    drawn with numpy from a fixed seed."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((LAYERS, D, D)).astype(np.float32) * 0.3
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return (torch.from_numpy(w).reshape(n_stages, LAYERS // n_stages, D, D),
            torch.from_numpy(x))


def stage(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    for layer in w:
        x = torch.tanh(x @ layer)
    return x


def _rank(rank: int, n: int, port: int, device: str) -> None:
    import torch.distributed as dist
    from repro_torch.dist.api import make_train_mesh
    from repro_torch.dist.pipeline import bubble_fraction, pipeline_apply
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_train_mesh((n,), device=device, names=("pp",))
        w, x = _model(n)
        w, x = w.to(mesh.device), x.to(mesh.device)
        y = pipeline_apply(stage, w, x, mesh.axis("pp"))
        ref = x
        for s in range(n):
            ref = stage(w[s], ref)
        err = float((y - ref).abs().max())
        if rank == 0:
            print(f"{n}-stage GPipe over {M} microbatches on {mesh.device}: "
                  f"max|err| vs sequential = {err:.2e}; point-to-point "
                  f"{mesh.stats['p2p_bytes']} B sent by rank 0")
            print(f"pipeline ok: bubble fraction (S-1)/(M+S-1) = "
                  f"{bubble_fraction(n, M):.0%}")
        if err >= 1e-5:
            raise SystemExit(f"rank {rank}: pipeline differs from the "
                             f"sequential model by {err:.2e}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--stages", type=int, default=None,
                    help="ranks / stages (default: 4 on the CPU, 2 on the "
                         "card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    n = args.stages or (4 if args.device == "cpu" else 2)
    if LAYERS % n:
        raise SystemExit(f"{LAYERS} layers do not split into {n} stages")
    import torch.multiprocessing as mp
    from repro_torch.dist.api import free_port
    mp.start_processes(_rank, args=(n, free_port(), args.device), nprocs=n,
                       start_method="spawn")


if __name__ == "__main__":
    main()
