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
AdamW updates the shards.

The serving steps run under any ``TrainMesh``, real or abstract
(``dist.api.make_abstract_mesh``), with the layouts of
``models.shard_for_training(..., serve=True)``: the batch split over the
rules' ``act_batch`` axes, weights split over "fsdp" (unless the rules
leave them whole, as the dry-run does under ``serve_layout == "tp"``)
and rows over "model".  Each step gathers the FSDP shards
(``serve_view``), binds them, and runs the model's ``prefill`` /
``decode_step`` on this rank's rows of the batch and caches.  A
compressed leaf is gathered as ``SparsityConfig.gather_compressed``
says: its values and indices (the compressed stream), or the dense view
of the rank's shard, compressed again once whole (``core.sparsity
.compress`` gives back the stored values), so the product takes the same
kernel either way.

The abstract state (``abstract_params``, ``abstract_caches``,
``abstract_opt_state``, ``train_input_specs``, ``decode_input_specs``)
is ``meta`` tensors with their logical specs: nothing is allocated, so
the dry-run runs a 480B model's step on one host.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import bind_params
from repro_torch.models.config import ArchConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
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


def serve_view(model: nn.Module, cfg: ArchConfig, layouts=None
               ) -> nn.Module:
    """``model`` with every leaf its layout splits over the data axes
    gathered (module docstring), for a serving forward under the active
    mesh; ``model`` itself without layouts or a mesh."""
    from repro_torch.core.layers import SparseLinear
    from repro_torch.core.sparsity import compress, decompress_parts
    from repro_torch.dist.api import current_mesh
    from repro_torch.dist.collectives import gather_dim
    mesh = current_mesh()
    if layouts is None or mesh is None:
        return model
    sp = cfg.sparsity
    names = {id(t): n for n, t in model.named_parameters()}
    names.update({id(t): n for n, t in model.named_buffers()})
    memo: Dict[int, torch.Tensor] = {}

    def whole(t: torch.Tensor) -> torch.Tensor:
        lay = layouts[names[id(t)]]
        if not lay.split:
            return t
        if id(t) not in memo:
            memo[id(t)] = gather_dim(t, mesh.axis(*lay.split), lay.dim)
        return memo[id(t)]

    def gathered_pair(lin: SparseLinear) -> Dict[str, torch.Tensor]:
        lay = layouts[names[id(lin.w_vals)]]
        if sp.gather_compressed or not lay.split:
            return {"w_vals": whole(lin.w_vals), "w_idx": whole(lin.w_idx)}
        k = lin.w_vals.shape[-1] * sp.m // sp.n
        dense = decompress_parts(lin.w_vals, lin.w_idx, sp.n, sp.m, k)
        full = compress(gather_dim(dense, mesh.axis(*lay.split), lay.dim),
                        sp.n, sp.m)
        return {"w_vals": full.values, "w_idx": full.indices}

    def walk(module: nn.Module) -> nn.Module:
        new = copy.copy(module)
        new._modules = {k: walk(m) for k, m in module._modules.items()}
        new._parameters = {k: None if t is None else whole(t)
                           for k, t in module._parameters.items()}
        packed = isinstance(module, SparseLinear) and module.compressed
        new._buffers = {k: None if t is None else whole(t)
                        for k, t in module._buffers.items()
                        if not (packed and k in ("w_vals", "w_idx"))}
        if packed:
            new._buffers.update(gathered_pair(module))
        return new

    return walk(model)


def make_prefill_step(cfg: ArchConfig, param_specs=None):
    """(model, batch) -> (greedy tokens [B] int32, caches).  Under a mesh
    ``model`` is a ``shard_for_training(..., serve=True)`` skeleton,
    ``param_specs`` its layouts and ``batch`` this rank's rows (module
    docstring)."""
    @torch.no_grad()
    def prefill_step(model, batch):
        view = serve_view(model, cfg, param_specs)
        logits, caches = tfm.prefill(view, cfg, batch)
        return logits.argmax(-1).to(torch.int32), caches
    return prefill_step


def make_decode_step(cfg: ArchConfig, param_specs=None):
    """(model, caches, tokens [B], pos) -> (greedy tokens [B] int32,
    caches), the caches written in place; under a mesh as
    ``make_prefill_step``, the caches this rank's (``local_caches``)."""
    @torch.no_grad()
    def decode_step(model, caches, tokens, pos):
        view = serve_view(model, cfg, param_specs)
        logits, new_caches = tfm.decode_step(view, cfg, caches, tokens, pos)
        return logits.argmax(-1).to(torch.int32), new_caches
    return decode_step


# -------------------------------------------------- abstract state + specs

def serve_config(cfg: ArchConfig) -> ArchConfig:
    """The serving model's config: compressed weights (the impl stays the
    policy's, so a step on the card takes the kernels)."""
    return cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                    mode="compressed"))


def abstract_params(cfg: ArchConfig, serve: bool = False):
    """(``meta`` model, its logical specs, the config it was built with):
    ``serve`` builds the compressed serving model."""
    c = serve_config(cfg) if serve else cfg
    model = tfm.init_model(c, device="meta")
    return model, tfm.train_shard_specs(model), c


def abstract_caches(cfg: ArchConfig, batch: int, max_len: int):
    """(``meta`` slotted decode caches, their logical specs)."""
    caches = tfm.init_caches(cfg, batch, max_len, device="meta")
    return caches, tfm.cache_specs(caches)


def abstract_opt_state(model: nn.Module, ocfg: AdamWConfig, param_specs):
    """(AdamW state of ``model``'s parameters, on their device, its
    specs): the moments and masters take their parameter's spec."""
    state = adamw_init(named_params(model), ocfg)
    specs = {part: dict(param_specs) for part in state if part != "step"}
    specs["step"] = None
    return state, specs


def train_input_specs(cfg: ArchConfig, batch: int, seq: int):
    """``meta`` tensors + logical specs of one global training batch."""
    from repro_torch.data.pipeline import batch_specs
    meta = torch.device("meta")
    shapes: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "embeds":
        shapes["embeds"] = torch.empty((batch, seq, cfg.d_model),
                                       dtype=torch.float32, device=meta)
    else:
        shapes["tokens"] = torch.empty((batch, seq), dtype=torch.int32,
                                       device=meta)
    shapes["labels"] = torch.empty((batch, seq), dtype=torch.int32,
                                   device=meta)
    if cfg.family == "audio":
        shapes["enc_embeds"] = torch.empty((batch, cfg.enc_seq, cfg.d_model),
                                           dtype=torch.float32, device=meta)
    return shapes, batch_specs(cfg, batch, seq)


def decode_input_specs(cfg: ArchConfig, batch: int):
    meta = torch.device("meta")
    return ({"tokens": torch.empty((batch,), dtype=torch.int32, device=meta),
             "pos": torch.empty((), dtype=torch.int32, device=meta)},
            {"tokens": ("act_batch",), "pos": None})


def local_caches(caches, mesh, rules):
    """This rank's part of whole decode caches under ``rules``: the batch
    over ``act_batch``, the heads / channels over "model".  The sequence
    stays whole (``act_seq_sp`` is dropped): the port's attention reads
    whole sequences of its heads, where the reference's partitioner may
    split the cache's sequence over "model" (ROADMAP C)."""
    from repro_torch.dist.api import make_shardings
    sh = make_shardings(tfm.cache_specs(caches), mesh,
                        dict(rules, act_seq_sp=None), caches)

    def cut(c, s):
        return {k: cut(v, s[k]) if isinstance(v, dict) else s[k](v)
                for k, v in c.items()}
    return cut(caches, sh)
