"""Elastic mesh planning (counterpart of ``repro.dist.elastic``): pick a
(data, model) mesh for whatever ranks survive, so training resumes after
a node loss instead of waiting for repair.

The recovery contract: a checkpoint written under mesh A restores under a
smaller mesh B.  Parameters and optimizer state are saved whole
("unsharded-logical", ``checkpoint.manager``) and cut to the new mesh's
shards on restore, so only the factorization is recomputed here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def _best_model_axis(ndev: int, prefer_model: int) -> int:
    """Largest model-parallel degree <= prefer_model that divides ndev.

    Model parallelism is the latency-critical axis (per-layer collectives),
    so it stays as close to the tuned size as the rank count allows and
    the remainder goes to data parallelism."""
    for m in range(min(max(prefer_model, 1), ndev), 0, -1):
        if ndev % m == 0:
            return m
    return 1


def degraded_meshes(ndev: int, losses: Sequence[int], prefer_model: int = 1
                    ) -> List[Tuple[int, Tuple[int, int]]]:
    """Mesh plan per failure scenario: [(remaining, (data, model)), ...].
    ``losses`` are rank counts lost (0 = healthy); scenarios that lose
    every rank are left out."""
    out: List[Tuple[int, Tuple[int, int]]] = []
    for loss in losses:
        n = ndev - loss
        if n <= 0:
            continue
        m = _best_model_axis(n, prefer_model)
        out.append((n, (n // m, m)))
    return out


def choose_mesh(ndev: Optional[int] = None, prefer_model: int = 1,
                backend: Optional[str] = None, device="cuda"):
    """The (data, model) ``TrainMesh`` over this process group: ``ndev``
    ranks (default: the group's world size, 1 without a group), the model
    axis ``_best_model_axis(ndev, prefer_model)``."""
    import torch.distributed as dist
    from repro_torch.dist.api import make_train_mesh
    n = ndev if ndev is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    m = _best_model_axis(n, prefer_model)
    return make_train_mesh((n // m, m), backend=backend, device=device)
