"""N:M structured sparsity format (counterpart of ``repro.core.sparsity``).

A matrix is N:M structured-sparse along its *last* axis when every
consecutive block of M elements holds at most N non-zeros.  The compressed
form stores, per block, exactly N (value, in-block column index) pairs; the
full column is ``block_id * M + col_idx``.

Layout convention: a weight W used as ``y = x @ W.T`` has shape [out, in] and
is sparsified along ``in`` (the contraction axis).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "NMSparse",
    "nm_mask",
    "sparsify",
    "compress",
    "decompress",
    "pack_indices",
    "pack_indices_i32",
    "unpack_indices",
    "storage_bytes",
    "validate_nm",
]


@dataclasses.dataclass
class NMSparse:
    """Compressed N:M sparse tensor (sparse along the last dense axis).

    values:  [..., rows, nnz] with nnz = in_dim // m * n (block-major: slot
             j belongs to block j // n, in-block slot j % n)
    indices: int8 [..., rows, nnz], each in [0, m), strictly increasing
             within a block's n slots.
    """

    values: torch.Tensor
    indices: torch.Tensor
    n: int
    m: int
    dense_shape: Tuple[int, ...]

    @property
    def nnz_per_row(self) -> int:
        return self.dense_shape[-1] // self.m * self.n

    @property
    def num_blocks(self) -> int:
        return self.dense_shape[-1] // self.m

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype


def _check_nm(in_dim: int, n: int, m: int) -> None:
    if not (0 < n < m):
        raise ValueError(f"need 0 < N < M, got {n}:{m}")
    if in_dim % m != 0:
        raise ValueError(f"last axis {in_dim} not divisible by block size M={m}")


def _block_rank(blocks: torch.Tensor) -> torch.Tensor:
    """Magnitude rank of every entry inside its M-block (0 = largest).

    Pairwise comparison: entry j outranks entry i when |w_j| > |w_i|, or the
    magnitudes tie and j < i — ties go to the lower index, the order of
    ``jax.lax.top_k``.  ``torch.topk`` promises no order on ties, so it is
    not used."""
    m = blocks.shape[-1]
    a = blocks.abs().float()
    ai = a.unsqueeze(-1)                              # [..., nb, m, 1]
    aj = a.unsqueeze(-2)                              # [..., nb, 1, m]
    ar = torch.arange(m, device=blocks.device)
    lower = ar.view(1, m) < ar.view(m, 1)             # [i, j]: j < i
    ahead = (aj > ai) | ((aj == ai) & lower)
    return ahead.sum(-1)                              # [..., nb, m]


def nm_mask(w: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Top-|N| magnitude mask per M-block along the last axis (exactly N per
    block, ties broken toward the lower index)."""
    _check_nm(w.shape[-1], n, m)
    blocks = w.reshape(*w.shape[:-1], w.shape[-1] // m, m)
    return (_block_rank(blocks) < n).reshape(w.shape)


def sparsify(w: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Dense -> dense with the N:M pattern enforced (magnitude pruning)."""
    return w * nm_mask(w, n, m).to(w.dtype)


def compress(w: torch.Tensor, n: int, m: int) -> NMSparse:
    """Dense [..., in] -> compressed: the top-N magnitudes of every M-block,
    stored in ascending in-block column order.  Selects the same entries as
    the reference's ``top_k`` + ``sort`` (ties to the lower index)."""
    _check_nm(w.shape[-1], n, m)
    blocks = w.reshape(*w.shape[:-1], w.shape[-1] // m, m)
    keep = _block_rank(blocks) < n                    # exactly n per block
    # stable sort of (not kept) puts the kept columns first, ascending
    idx = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[..., :n]
    vals = torch.take_along_dim(blocks, idx, dim=-1)
    nnz = w.shape[-1] // m * n
    return NMSparse(values=vals.reshape(*w.shape[:-1], nnz),
                    indices=idx.to(torch.int8).reshape(*w.shape[:-1], nnz),
                    n=n, m=m, dense_shape=tuple(w.shape))


def decompress_parts(values: torch.Tensor, indices: torch.Tensor, n: int,
                     m: int, k: int, dtype=None) -> torch.Tensor:
    """[..., rows, nnz] values + in-block indices -> dense [..., rows, k].

    Slot loop (the order of the reference's in-kernel decompress): for each
    of the N in-block slots, place its value at ``block * M + idx``.  Exact —
    every dense entry receives at most one value."""
    dtype = dtype or values.dtype
    lead = values.shape[:-1]
    nb = k // m
    vals3 = values.reshape(*lead, nb, n).to(dtype)
    idx3 = indices.reshape(*lead, nb, n).long()
    dense = torch.zeros(*lead, nb, m, dtype=dtype, device=values.device)
    dense.scatter_(-1, idx3, vals3)
    return dense.reshape(*lead, k)


def decompress(sp: NMSparse) -> torch.Tensor:
    """Compressed -> dense (``block_id * M + col_idx`` reconstruction)."""
    return decompress_parts(sp.values, sp.indices, sp.n, sp.m,
                            sp.dense_shape[-1]).reshape(sp.dense_shape)


# ---------------------------------------------------------------------------
# ceil(log2 M)-bit index packing: the paper's storage accounting.
# ---------------------------------------------------------------------------

def index_bits(m: int) -> int:
    return max(1, int(math.ceil(math.log2(m))))


def _packed_words(indices: torch.Tensor, m: int) -> torch.Tensor:
    """The packed words as int64 values in [0, 2**32)."""
    bits = index_bits(m)
    per_word = 32 // bits
    nnz = indices.shape[-1]
    pad = (-nnz) % per_word
    idx = torch.nn.functional.pad(indices.to(torch.int64), (0, pad))
    idx = idx.reshape(*indices.shape[:-1], -1, per_word)
    shifts = torch.arange(per_word, device=indices.device) * bits
    return (idx << shifts).sum(-1)


def pack_indices(indices: torch.Tensor, m: int) -> torch.Tensor:
    """int8 in-block indices -> packed uint32 words along the last axis
    (slot s of a word occupies bits [s*bits, (s+1)*bits))."""
    return _packed_words(indices, m).to(torch.uint32)


def pack_indices_i32(indices: torch.Tensor, m: int) -> torch.Tensor:
    """``pack_indices``' words as int32 with the same 32 bits (torch's
    uint32 support is thin; a kernel reads them as raw 32-bit words).
    ``unpack_indices`` takes either."""
    w = _packed_words(indices, m)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_indices(packed: torch.Tensor, m: int, nnz: int) -> torch.Tensor:
    """Packed words (uint32, or their int32 bit patterns) -> int8 in-block
    indices (inverse of pack)."""
    bits = index_bits(m)
    per_word = 32 // bits
    words = packed.to(torch.int64)
    shifts = torch.arange(per_word, device=packed.device) * bits
    idx = (words.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)
    return idx.reshape(*packed.shape[:-1], -1)[..., :nnz].to(torch.int8)


def storage_bytes(sp: NMSparse, packed: bool = True,
                  full_column: bool = False) -> int:
    """Bytes to store the compressed tensor: packed ceil(log2 M)-bit indices
    (the paper's format), int8 indices, or full int32 column ids (the
    Alg-3S-FC baseline)."""
    nvals = sp.values.numel()
    val_bytes = nvals * sp.values.element_size()
    if full_column:
        idx_bytes = nvals * 4
    elif packed:
        idx_bytes = int(math.ceil(nvals * index_bits(sp.m) / 8))
    else:
        idx_bytes = nvals
    return val_bytes + idx_bytes


def validate_nm(w_or_sp, n: int | None = None, m: int | None = None) -> bool:
    """True iff the argument satisfies the N:M constraint: a dense tensor
    (needs n, m) or an NMSparse (indices in range, strictly increasing
    within each block)."""
    if isinstance(w_or_sp, NMSparse):
        sp = w_or_sp
        lead = sp.dense_shape[:-1]
        idx = sp.indices.cpu().numpy().reshape(*lead, sp.num_blocks, sp.n)
        in_range = bool(((idx >= 0) & (idx < sp.m)).all())
        increasing = bool((np.diff(idx, axis=-1) > 0).all()) if sp.n > 1 else True
        return in_range and increasing
    if n is None or m is None:
        raise ValueError("validate_nm on a dense tensor needs n and m")
    w = w_or_sp
    blocks = w.reshape(*w.shape[:-1], w.shape[-1] // m, m)
    return bool(((blocks != 0).sum(-1) <= n).all())
