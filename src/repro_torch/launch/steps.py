"""Step functions of the trainer and the greedy server (counterpart of
``repro.launch.steps``): ``make_train_step`` (gradient accumulation, the
warmup-cosine schedule, clipped AdamW), ``make_prefill_step`` /
``make_decode_step`` (greedy wrappers).

The model is an ``nn.Module`` whose parameters are the trained leaves
(``named_params`` turns their gradients on); the step updates it and the
optimizer state in place.

Under a training mesh (``dist.api.axis_rules`` with a ``TrainMesh``) the
model is the skeleton of ``models.shard_for_training`` and
``param_specs`` its layouts: each rank's parameters, f32 masters and
AdamW moments are its shards.  Each microbatch gathers the whole leaves
over the data axes (``dist.collectives.fsdp_gather``), puts them in the
skeleton (``models.bind_params``) and differentiates this rank's share
of the global loss; the gathers' backward reduce-scatters the gradients
back to the shards, summed.  ``pregather_fsdp`` gathers once before the
accumulation loop, sums the whole-leaf gradients in f32 unreduced and
reduce-scatters once after it (the reference's semantics): the gather
and reduce-scatter bytes no longer grow with the accumulation depth.
The global norm is one all-reduce (``optim.sharded_global_norm``), and
AdamW updates the shards.  The abstract state of the dry-run is not
ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import bind_params
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.optim.adamw import sharded_global_norm


def named_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, their gradients turned on."""
    out = {}
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        out[name] = p
    return out


def make_train_step(cfg: ArchConfig, ocfg: AdamWConfig, base_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10000,
                    param_specs=None, accum: Optional[int] = None,
                    pregather_fsdp: bool = False):
    """(model, opt_state, batch, step) -> (model, opt_state, metrics
    {"loss", "gnorm", "lr"}), the model and state updated in place.
    ``accum`` overrides ``cfg.grad_accum``.  Under an active training
    mesh ``model`` is a ``shard_for_training`` skeleton, ``param_specs``
    its layouts, ``batch`` this rank's rows (``data.local_batch`` with
    the same ``accum``) and the metrics the global ones (module
    docstring)."""
    accum = max(accum if accum is not None else cfg.grad_accum, 1)

    def train_step(model, opt_state, batch, step):
        from repro_torch.dist.api import current_mesh
        mesh = current_mesh()
        if mesh is not None and param_specs is None:
            raise ValueError("a step under a training mesh needs "
                             "param_specs, the layouts of "
                             "models.shard_for_training")
        layouts = param_specs if mesh is not None else None
        with torch.autograd.profiler.record_function("train.grads"):
            loss, grads = loss_and_grads(model, cfg, batch, accum, layouts,
                                         pregather_fsdp)
        lr = warmup_cosine(step, base_lr, warmup, total)
        with torch.autograd.profiler.record_function("train.adamw"):
            gnorm = None if layouts is None else sharded_global_norm(
                grads, {k: layouts[k].rep for k in grads}, mesh)
            _, opt_state, gnorm = adamw_update(
                grads, opt_state, named_params(model), lr, ocfg, gnorm=gnorm)
        return model, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step


def _groups(layout, mesh):
    """(split group, dim, rest group) of a leaf's layout."""
    split = mesh.axis(*layout.split) if layout.split else None
    rest = mesh.axis(*layout.rest) if layout.rest else None
    return split, layout.dim, rest


def loss_and_grads(model: nn.Module, cfg: ArchConfig,
                   batch: Dict[str, torch.Tensor], accum: int = 1,
                   layouts=None, pregather: bool = False):
    """(mean loss over ``accum`` microbatches, {name: gradient}) of one
    batch of any family ({"tokens" or "embeds", "labels"}, plus the audio
    family's "enc_embeds").  Every entry splits along its first axis into
    ``accum`` equal microbatches whose gradients sum in f32 and are
    divided by ``accum``; with ``accum == 1`` the gradients keep the
    parameters' dtypes, as the reference's.  Under a training mesh
    (``layouts``: the skeleton's, ``models.shard_for_training``) ``batch``
    is this rank's rows, the loss the global mean and each gradient this
    rank's shard (module docstring)."""
    from repro_torch.dist.api import batch_axis, current_mesh
    from repro_torch.dist.collectives import (all_reduce, fsdp_gather,
                                              fsdp_reduce, gather_dim)
    mesh = current_mesh() if layouts is not None else None
    pregather = pregather and mesh is not None
    params = named_params(model)
    groups = {k: _groups(layouts[k], mesh) if mesh is not None
              else (None, None, None) for k in params}
    rows = next(iter(batch.values())).shape[0]
    if rows % accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{accum} microbatches")
    mb = rows // accum
    lsum = 0.0
    if pregather:
        with torch.no_grad(), torch.autograd.profiler.record_function(
                "train.fsdp_gather"):
            leaves = {k: gather_dim(p, groups[k][0], groups[k][1])
                      .detach().requires_grad_(True)
                      for k, p in params.items()}
        view = bind_params(model, leaves)
        wrt = list(leaves.values())
    else:
        wrt = list(params.values())
    gsum = None
    for i in range(accum):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        if not pregather:
            view = bind_params(model, {
                k: fsdp_gather(p, *groups[k]) for k, p in params.items()})
        loss, _ = tfm.loss_fn(view, cfg, part)
        grads = torch.autograd.grad(loss, wrt)
        lsum = lsum + loss.detach()
        if accum == 1 and not pregather:
            gsum = grads
            break
        with torch.autograd.profiler.record_function("train.accumulate"):
            if gsum is None:
                gsum = [torch.zeros(g.shape, dtype=torch.float32,
                                    device=g.device) for g in grads]
            for acc, g in zip(gsum, grads):
                acc.add_(g.float())
        del grads
    if pregather:
        with torch.autograd.profiler.record_function("train.fsdp_reduce"):
            gsum = [fsdp_reduce(g, *groups[k]) for k, g in zip(params, gsum)]
    grads = dict(zip(params, gsum))
    if accum > 1 or pregather:
        grads = {k: g / accum for k, g in grads.items()}
    loss = lsum / accum
    group = batch_axis() if mesh is not None else None
    if group is not None:
        loss = all_reduce(loss, group)
    return loss, grads


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
