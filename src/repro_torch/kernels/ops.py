"""Public N:M kernel entry points and the analytic traffic model
(counterpart of ``repro.kernels.ops``).

``nm_xwt``, ``nm_spmm`` and ``nm_spmv`` front the CUDA kernels (they take
any leading shape and mask ragged edges in-kernel, so nothing is padded
here).  ``nm_xwt(packed=True)`` packs the int8 indices into the paper's
ceil(log2 M)-bit words inside the wrapper, as the reference does, and runs
the packed kernel; it accepts and rejects the same (shape, block) cases as
the reference.  The ``traffic_*`` formulas count bytes and FLOPs from shapes
alone and do not depend on hardware; they keep the reference's tiling
(``pick_block_*``) so the two packages model the same schedule.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import torch

from repro_torch.core.sparsity import index_bits, pack_indices_i32
from repro_torch.kernels import nm_spmm as _spmm
from repro_torch.kernels.nm_spmm import nm_spmm
from repro_torch.kernels.nm_spmv import nm_spmv

__all__ = ["nm_xwt", "nm_spmm", "nm_spmv", "pack_block_indices",
           "pick_block_mm", "pick_block_spmv", "traffic_mm", "traffic_spmv"]

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


def pack_block_indices(indices: torch.Tensor, n: int, m: int,
                       block: Tuple[int, int, int]) -> torch.Tensor:
    """int8 indices [O, K/M*N] -> the packed kernel's int32 words [O,
    ceil(nnz / per_word)].  The reference packs per K-block of its ``bk``
    so every tile starts on a word, and rejects a block whose slot count
    ``bk/M*N`` is not a whole number of words (``ops.py:72-82``); the same
    check runs here.  Where it passes, the per-block words are the row's
    words in order, which is what the port's kernel reads (it addresses
    entry ``e`` as word ``e // per_word`` and does not rely on tile
    alignment)."""
    bk = block[2]
    if bk % m:
        raise ValueError(f"bk={bk} must be a multiple of M={m}")
    per_word = 32 // index_bits(m)
    bnnz = bk // m * n
    if bnnz % per_word:
        raise ValueError(f"bnnz={bnnz} not a multiple of {per_word}")
    return pack_indices_i32(indices, m)


def nm_xwt(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
           n: int, m: int, *, packed: bool = False,
           block: Tuple[int, int, int] | None = None,
           plan_o: int | None = None) -> torch.Tensor:
    """Y = X @ W_sp.T for X [..., K]; W compressed [O, K/M*N] with int8
    indices.  ``packed=True`` packs the indices per ``block`` (default: the
    reference's ``pick_block_mm``) and runs the packed kernel; ``block``
    decides only which packed layouts are accepted, as in the reference
    (the port's kernel tiles on its own).  ``plan_o``: the whole O of a
    row shard, whose launch plan the int8 launch takes."""
    if not packed:
        return _spmm.nm_xwt(x, values, indices, n, m, plan_o)
    k = x.shape[-1]
    rows = x.numel() // max(k, 1)
    blk = block or pick_block_mm(rows, values.shape[0], k, n, m)
    words = pack_block_indices(indices, n, m, blk)
    return _spmm.nm_xwt_packed(x, values, words, n, m)


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
