"""Step functions of the trainer and the greedy server (counterpart of
``repro.launch.steps``): ``make_train_step`` (gradient accumulation, the
warmup-cosine schedule, clipped AdamW), ``make_prefill_step`` /
``make_decode_step`` (greedy wrappers).

The model is an ``nn.Module`` whose parameters are the trained leaves
(``named_params`` turns their gradients on); the step updates it and the
optimizer state in place.  Sharding (``param_specs``, ``pregather_fsdp``,
the abstract state of the dry-run) comes with tensor-parallel training.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine


def named_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, their gradients turned on."""
    out = {}
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        out[name] = p
    return out


def loss_and_grads(model: nn.Module, cfg: ArchConfig,
                   batch: Dict[str, torch.Tensor], accum: int = 1):
    """(mean loss over ``accum`` microbatches, {name: gradient}) of one
    batch of any family ({"tokens" or "embeds", "labels"}, plus the audio
    family's "enc_embeds").  Every entry splits along its first axis into
    ``accum`` equal microbatches whose gradients sum in f32 and are divided by ``accum``;
    with ``accum == 1`` the gradients keep the parameters' dtypes, as the
    reference's."""
    params = named_params(model)
    leaves = list(params.values())
    if accum == 1:
        loss, _ = tfm.loss_fn(model, cfg, batch)
        return loss.detach(), dict(zip(params, torch.autograd.grad(loss,
                                                                   leaves)))
    rows = next(iter(batch.values())).shape[0]
    if rows % accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{accum} microbatches")
    mb = rows // accum
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    lsum = 0.0
    for i in range(accum):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, _ = tfm.loss_fn(model, cfg, part)
        grads = torch.autograd.grad(loss, leaves)
        with torch.autograd.profiler.record_function("train.accumulate"):
            for acc, g in zip(gsum, grads):
                acc.add_(g.float())
        del grads
        lsum = lsum + loss.detach()
    return lsum / accum, {k: g / accum for k, g in zip(params, gsum)}


def make_train_step(cfg: ArchConfig, ocfg: AdamWConfig, base_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10000,
                    accum: Optional[int] = None):
    """(model, opt_state, batch, step) -> (model, opt_state, metrics
    {"loss", "gnorm", "lr"}), the model and state updated in place.
    ``accum`` overrides ``cfg.grad_accum``."""
    accum = max(accum if accum is not None else cfg.grad_accum, 1)

    def train_step(model, opt_state, batch, step):
        with torch.autograd.profiler.record_function("train.grads"):
            loss, grads = loss_and_grads(model, cfg, batch, accum)
        lr = warmup_cosine(step, base_lr, warmup, total)
        with torch.autograd.profiler.record_function("train.adamw"):
            _, opt_state, gnorm = adamw_update(grads, opt_state,
                                               named_params(model), lr, ocfg)
        return model, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def prefill_step(model, batch):
        logits, caches = tfm.prefill(model, cfg, batch)
        return logits.argmax(-1).to(torch.int32), caches
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    @torch.no_grad()
    def decode_step(model, caches, tokens, pos):
        logits, new_caches = tfm.decode_step(model, cfg, caches, tokens, pos)
        return logits.argmax(-1).to(torch.int32), new_caches
    return decode_step
