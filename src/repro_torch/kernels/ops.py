"""Public N:M kernel entry points and the analytic traffic model
(counterpart of ``repro.kernels.ops``).

``nm_xwt`` and ``nm_spmv`` are the wrappers of the CUDA kernels (they take
any leading shape and mask ragged edges in-kernel, so nothing is padded
here).  The ``traffic_*`` formulas count bytes and FLOPs from shapes alone
and do not depend on hardware; they keep the reference's tiling
(``pick_block_*``) so the two packages model the same schedule.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.kernels.nm_spmm import nm_xwt
from repro_torch.kernels.nm_spmv import nm_spmv

__all__ = ["nm_xwt", "nm_spmv", "pick_block_mm", "pick_block_spmv",
           "traffic_mm", "traffic_spmv"]

DEFAULT_BLOCK = (128, 128, 512)     # (bm, bn, bk) of the reference xwt tile
DEFAULT_BLOCK_SPMV = (128, 1024)    # (bo, bk) of the reference spmv tile


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def pick_block_mm(bsz: int, o: int, k: int, n: int, m: int,
                  want: Tuple[int, int, int] = DEFAULT_BLOCK):
    """Block sizes of the reference matmul tiling; shrinks for small
    problems."""
    bm = min(want[0], _round_up(bsz, 8))
    bn = min(want[1], _round_up(o, 128) if o >= 128 else o)
    bk = min(_round_up(want[2], m), _round_up(k, m))
    return bm, bn, bk


def pick_block_spmv(bsz: int, o: int, k: int, n: int, m: int,
                    want: Tuple[int, int] = DEFAULT_BLOCK_SPMV):
    bo = min(want[0], _round_up(o, 128) if o >= 128 else o)
    bk = min(_round_up(want[1], m), _round_up(k, m))
    return bo, bk


def traffic_mm(bsz: int, o: int, k: int, n: int, m: int, *,
               dtype_bytes: int = 2,
               block: Tuple[int, int, int] | None = None,
               sparse: bool = True) -> dict:
    """Bytes + flops for Y = X @ W.T under the tiled (i, j, kk) schedule:
    x re-streamed per output-column tile, w per row tile; sparse index bytes
    at the packed ceil(log2 M)-bit width."""
    bm, bn, bk = block or pick_block_mm(bsz, o, k, n, m)
    bp, op, kp = _round_up(bsz, bm), _round_up(o, bn), _round_up(k, bk)
    j_steps = op // bn
    i_steps = bp // bm
    x_bytes = j_steps * bp * kp * dtype_bytes
    if sparse:
        idx_bits = max(1, int(np.ceil(np.log2(m))))
        w_elem_bytes = (n / m) * (dtype_bytes + idx_bits / 8)
    else:
        w_elem_bytes = dtype_bytes
    w_bytes = i_steps * op * kp * w_elem_bytes
    out_bytes = bp * op * dtype_bytes
    mxu_flops = 2.0 * bp * op * kp
    vpu_flops = (3.0 * n) * (op * kp) * i_steps if sparse else 0.0
    return dict(hbm_bytes=x_bytes + w_bytes + out_bytes,
                w_bytes=w_bytes, x_bytes=x_bytes, out_bytes=out_bytes,
                mxu_flops=mxu_flops, vpu_flops=vpu_flops)


def traffic_spmv(bsz: int, o: int, k: int, n: int, m: int, *,
                 dtype_bytes: int = 2,
                 block: Tuple[int, int] | None = None,
                 sparse: bool = True, mode: str = "gather") -> dict:
    """Bytes + flops for the decode matvec (x resident, W streamed once)."""
    bo, bk = block or pick_block_spmv(bsz, o, k, n, m)
    bp = _round_up(bsz, 8)
    op, kp = _round_up(o, bo), _round_up(k, bk)
    x_bytes = (op // bo) * bp * kp * dtype_bytes if op > bo else bp * kp * dtype_bytes
    if sparse:
        idx_bits = max(1, int(np.ceil(np.log2(m))))
        w_elem_bytes = (n / m) * (dtype_bytes + idx_bits / 8)
        flops = 2.0 * bp * op * kp * (n / m) if mode == "gather" else 2.0 * bp * op * kp
    else:
        w_elem_bytes = dtype_bytes
        flops = 2.0 * bp * op * kp
    w_bytes = op * kp * w_elem_bytes
    out_bytes = bp * op * dtype_bytes
    return dict(hbm_bytes=x_bytes + w_bytes + out_bytes,
                w_bytes=w_bytes, x_bytes=x_bytes, out_bytes=out_bytes,
                mxu_flops=flops if mode != "gather" else 0.0,
                vpu_flops=flops if mode == "gather" else 0.0)
