"""Gated MLP (counterpart of the MLP half of ``repro.models.ffn``; the MoE
layers arrive with the MoE family)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.layers import SparseLinear, linear_apply, linear_init
from repro_torch.models.common import ACTIVATIONS
from repro_torch.models.config import ArchConfig


class MLP(nn.Module):
    def __init__(self, wg: SparseLinear, wu: SparseLinear, wd: SparseLinear):
        super().__init__()
        self.wg, self.wu, self.wd = wg, wu, wd


def mlp_init(gen: torch.Generator, cfg: ArchConfig, dtype, device="cuda",
             d_ff: Optional[int] = None) -> MLP:
    d, dff, sp = cfg.d_model, d_ff or cfg.d_ff, cfg.sparsity
    return MLP(linear_init(gen, d, dff, sp, dtype, device),
               linear_init(gen, d, dff, sp, dtype, device),
               linear_init(gen, dff, d, sp, dtype, device))


def mlp_apply(p: MLP, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    sp = cfg.sparsity
    act = ACTIVATIONS[cfg.act]
    h = act(linear_apply(p.wg, x, sp)) * linear_apply(p.wu, x, sp)
    return linear_apply(p.wd, h, sp)
