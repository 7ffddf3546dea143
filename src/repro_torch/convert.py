"""Carry reference-initialized weights into the port.

``from_reference_params`` takes the reference ``init_model`` parameter tree
*as numpy arrays* (the caller maps every leaf through ``np.asarray``) and
returns the port's ``DenseLM``.  Linear leaves may be dense ``{"w"}`` or
compressed ``{"w_vals", "w_idx"}``; the stacked ``[L, ...]`` layer leaves
are split per layer.  This is how the parity tests feed both packages the
same weights (their random generators cannot agree).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.layers import SparseLinear
from repro_torch.models.attention import GQA
from repro_torch.models.common import Embedding, RMSNorm
from repro_torch.models.config import ArchConfig
from repro_torch.models.ffn import MLP
from repro_torch.models.transformer import DenseBlock, DenseLM, _check_family


def to_torch(a: np.ndarray, device="cuda") -> torch.Tensor:
    """numpy -> torch, bit for bit.  A bfloat16 array (the ml_dtypes type
    numpy reports as ``bfloat16``, which ``torch.from_numpy`` rejects) is
    reinterpreted through its 16-bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _linear(tree: Mapping[str, np.ndarray], device) -> SparseLinear:
    kw = {k: to_torch(v, device) for k, v in tree.items()}
    return SparseLinear(**kw)


def _layer(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Slice layer ``i`` out of a stacked [L, ...] subtree."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def from_reference_params(tree: Mapping[str, Any], cfg: ArchConfig,
                          device="cuda") -> DenseLM:
    """Reference dense-family parameter tree (numpy leaves) -> ``DenseLM``."""
    _check_family(cfg)
    device = resolve_device(device)
    blocks = []
    for i in range(cfg.n_layers):
        lt = _layer(tree["layers"], i)
        a, f = lt["attn"], lt["mlp"]
        blocks.append(DenseBlock(
            RMSNorm(to_torch(lt["ln1"]["scale"], device)),
            GQA(*(_linear(a[k], device) for k in ("wq", "wk", "wv", "wo"))),
            RMSNorm(to_torch(lt["ln2"]["scale"], device)),
            MLP(*(_linear(f[k], device) for k in ("wg", "wu", "wd")))))
    return DenseLM(Embedding(to_torch(tree["embed"]["emb"], device)), blocks,
                   RMSNorm(to_torch(tree["lnf"]["scale"], device)))
