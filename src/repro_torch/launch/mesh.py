"""Production mesh construction (counterpart of ``repro.launch.mesh``).

Single pod: 16x16 = 256 cards (data, model).
Multi-pod:  2x16x16 = 512 cards (pod, data, model): the pod axis carries
cross-pod data parallelism.

The meshes are abstract (``dist.api.make_abstract_mesh``): this process
is rank 0 of a mesh no run here has, its tensors ``meta``, its
collectives counted and not sent.  The dry-run runs one rank's step on
them.
"""

from __future__ import annotations

from repro_torch.dist.api import make_abstract_mesh


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)
