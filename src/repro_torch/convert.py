"""Carry reference-initialized weights into the port.

``from_reference_params`` takes the reference ``init_model`` parameter tree
*as numpy arrays* (the caller maps every leaf through ``np.asarray``) and
returns the port's ``DenseLM`` (dense family) or ``MoELM`` (MoE family:
``dense_layers`` and ``layers`` with MLA or GQA attention and a ``moe``
subtree of router, stacked experts and shared MLP).  Linear leaves may be
dense ``{"w"}`` or compressed ``{"w_vals", "w_idx"}``; the stacked
``[L, ...]`` layer leaves are split per layer, an expert stack keeps its
``[E, ...]`` axis.  This is how the parity tests feed both packages the
same weights (their random generators cannot agree).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.layers import SparseLinear, StackedLinear
from repro_torch.models.attention import GQA, MLA
from repro_torch.models.common import Embedding, RMSNorm
from repro_torch.models.config import ArchConfig
from repro_torch.models.ffn import MLP, MoE
from repro_torch.models.transformer import (LM, DenseBlock, DenseLM, MoEBlock,
                                            MoELM, _check_family)


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


def _linear(tree: Mapping[str, np.ndarray], device,
            cls=SparseLinear) -> SparseLinear:
    kw = {k: to_torch(v, device) for k, v in tree.items()}
    return cls(**kw)


def _layer(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Slice layer ``i`` out of a stacked [L, ...] subtree."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _norm(tree, device) -> RMSNorm:
    return RMSNorm(to_torch(tree["scale"], device))


def _attn(a: Mapping[str, Any], cfg: ArchConfig, device):
    names = ("wq", "wdkv", "wuk", "wuv", "wo") if cfg.mla \
        else ("wq", "wk", "wv", "wo")
    return (MLA if cfg.mla else GQA)(*(_linear(a[k], device) for k in names))


def _mlp(f: Mapping[str, Any], device) -> MLP:
    return MLP(*(_linear(f[k], device) for k in ("wg", "wu", "wd")))


def _dense_block(lt, cfg: ArchConfig, device) -> DenseBlock:
    return DenseBlock(_norm(lt["ln1"], device), _attn(lt["attn"], cfg, device),
                      _norm(lt["ln2"], device), _mlp(lt["mlp"], device))


def _moe_block(lt, cfg: ArchConfig, device) -> MoEBlock:
    mt = lt["moe"]
    stacks = (_linear(mt[k], device, StackedLinear) for k in ("wg", "wu", "wd"))
    moe = MoE(to_torch(mt["router"]["w"], device), *stacks,
              shared=_mlp(mt["shared"], device) if "shared" in mt else None)
    return MoEBlock(_norm(lt["ln1"], device), _attn(lt["attn"], cfg, device),
                    _norm(lt["ln2"], device), moe,
                    _mlp(lt["mlp"], device) if "mlp" in lt else None)


def from_reference_params(tree: Mapping[str, Any], cfg: ArchConfig,
                          device="cuda") -> LM:
    """Reference dense- or MoE-family parameter tree (numpy leaves) -> the
    port's model."""
    _check_family(cfg)
    device = resolve_device(device)
    embed = Embedding(to_torch(tree["embed"]["emb"], device))
    lnf = _norm(tree["lnf"], device)
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        dense = [_dense_block(_layer(tree["dense_layers"], i), cfg, device)
                 for i in range(nd)]
        moe = [_moe_block(_layer(tree["layers"], i), cfg, device)
               for i in range(cfg.n_layers - nd)]
        return MoELM(embed, dense, moe, lnf)
    return DenseLM(embed, [_dense_block(_layer(tree["layers"], i), cfg, device)
                           for i in range(cfg.n_layers)], lnf)
