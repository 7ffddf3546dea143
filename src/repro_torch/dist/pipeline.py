"""Pipeline parallelism: the GPipe schedule over a mesh axis (counterpart
of ``repro.dist.pipeline``).

Stage s lives on rank s; microbatches stream through a ring of
point-to-point sends (``dist.collectives.send_recv``).  At tick t rank s
processes microbatch t - s, so the pipeline fills in S - 1 ticks and
drains in S - 1: bubble fraction (S - 1) / (M + S - 1).  Activation
traffic is neighbour to neighbour; nothing is all-gathered until the last
stage's finished outputs are shared (one all-reduce, as the reference's
psum).  Like the reference, no model calls it.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.dist.collectives import all_reduce, send_recv


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _stage(params, s: int):
    """Stage ``s``'s slice of stacked params (a tensor [n_stages, ...] or
    a dict of them)."""
    if isinstance(params, dict):
        return {k: v[s] for k, v in params.items()}
    return params[s]


@torch.no_grad()
def pipeline_apply(stage_fn: Callable, params, x: torch.Tensor, mesh
                   ) -> torch.Tensor:
    """Apply S sequential stages to M microbatches, pipelined over
    ``mesh`` (an ``AxisGroup`` of S ranks; rank s runs stage s).

    ``stage_fn(stage_params, xb) -> yb`` keeps xb's shape (stages chain);
    ``params`` a tensor [S, ...] or a dict of them (rank s reads
    ``leaf[s]`` only);
    ``x`` [M, ...microbatch...], the same on every rank.  Returns [M, ...],
    stage_{S-1}(... stage_0(x) ...) per microbatch, on every rank."""
    n, s = mesh.size, mesh.rank
    first = next(iter(params.values())) if isinstance(params, dict) \
        else params
    n_stages = first.shape[0]
    if n_stages != n:
        raise ValueError(f"{n_stages} stages need an axis of the same size, "
                         f"the mesh has {n}")
    w = _stage(params, s)
    num_mb = x.shape[0]
    carry = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(num_mb + n - 1):
        # rank 0 injects microbatch t; every other rank consumes the ring
        inp = (x[t] if t < num_mb else torch.zeros_like(carry)) \
            if s == 0 else carry
        out = stage_fn(w, inp)
        slot = t - (n - 1)                 # the microbatch the last stage
        if slot >= 0 and s == n - 1:       # just finished
            outs[slot] = out
        if t != num_mb + n - 2:
            carry = send_recv(out, mesh)
    # only the last rank's outputs are finished work: share them
    return all_reduce(outs if s == n - 1 else torch.zeros_like(outs), mesh)
