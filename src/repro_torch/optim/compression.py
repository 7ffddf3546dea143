"""Gradient compression for the cross-pod all-reduce (counterpart of
``repro.optim.compression``).

At pod scale the slow hop is the cross-pod gradient all-reduce, so that
hop is compressed: int8 (a per-tensor scale; the ranks agree on the
largest scale first, so their int8 payloads are commensurable, and the
payloads sum exactly in int32) or bf16 (rounded, summed in f32).  The
reduce runs over one axis of a training mesh (``dist.api.TrainMesh``)
through ``dist.collectives.all_reduce``; intra-pod reductions stay full
precision.  The results are the mean over the axis, as the reference's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-d): x ~= q * scale, |q| <= 127."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def _group(mesh, axis_name: Optional[str]):
    return mesh.axis(axis_name) if axis_name is not None else mesh


def compressed_psum(x: torch.Tensor, mesh, axis_name: Optional[str] = None,
                    method: str = "int8") -> torch.Tensor:
    """The mean of every rank's ``x`` over ``mesh``'s axis ``axis_name``
    (``mesh`` itself when None: an ``AxisGroup``), in f32, reduced in
    compressed form.

    int8: quantize -> an all-reduce of the int32 payloads (exact) ->
    dequantize with the shared max scale.  bf16: round to bf16, sum in
    f32."""
    from repro_torch.dist.collectives import all_reduce
    group = _group(mesh, axis_name)
    n = group.size
    if method == "bf16":
        return all_reduce(compress_bf16(x).float(), group) / n
    if method != "int8":
        raise ValueError(f"method must be 'int8' or 'bf16', got {method!r}")
    q, scale = quantize_int8(x)
    smax = all_reduce(scale, group, op="max")
    q = torch.clamp(torch.round(dequantize_int8(q, scale) / smax),
                    -127, 127).to(torch.int8)
    tot = all_reduce(q.to(torch.int32), group)
    return tot.float() * smax / n


def compressed_grad_psum(grads: Dict[str, torch.Tensor], mesh,
                         axis_name: Optional[str] = None,
                         method: str = "int8") -> Dict[str, torch.Tensor]:
    """``compressed_psum`` of every gradient, each back in its dtype."""
    return {k: compressed_psum(g, mesh, axis_name, method).to(g.dtype)
            for k, g in grads.items()}
