"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; every module here mirrors its
counterpart's path (``repro_torch.core.sparsity`` <-> ``repro.core.sparsity``)
so a reader can find each piece.  This package imports torch, numpy and the
standard library only.

Entry points (``models.init_model``, ``serve.ServeEngine``,
``launch.serve``) run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for the card on a machine without one raises.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' explicitly to run the plain path")
    return dev
