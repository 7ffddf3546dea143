"""AdamW with f32 master weights (counterpart of ``repro.optim.adamw``).

The parameters, their gradients and every state tensor are ordered dicts
keyed by the model's parameter names (``model.named_parameters()``), so
each state tensor has a counterpart leaf in the reference's tree
(``convert.from_reference_opt_state`` maps one onto the other).  The
update writes the parameters and the state in place; the parameters stay
the model's own tensors.  On a training mesh the parameters, gradients
and state are this rank's shards (``launch.steps``): the update is
elementwise, and ``sharded_global_norm`` gives the one global norm the
clip needs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

Named = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_weights: bool = True   # f32 master copy for bf16 params


def adamw_init(params: Named, cfg: AdamWConfig) -> Dict[str, object]:
    """{"mu", "nu": f32 zeros per parameter, "step": int32 0-d, "master":
    f32 copies (with ``master_weights``)}, on the parameters' device."""
    dev = next(iter(params.values())).device
    state: Dict[str, object] = {
        "mu": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.master_weights:
        state["master"] = {k: p.detach().to(torch.float32, copy=True)
                           for k, p in params.items()}
    return state


def _global_norm(grads: Named) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def sharded_global_norm(grads: Named, reps: Mapping[str, int], mesh
                        ) -> torch.Tensor:
    """The global L2 norm of gradients held as shards over ``mesh``: each
    leaf's sum of squares over ``reps[name]``, the ranks holding each of
    its elements (so a replicated leaf counts once), summed over the
    leaves, then over every rank in one all-reduce."""
    from repro_torch.dist.collectives import all_reduce
    sq = sum(s if reps[k] == 1 else s / reps[k] for k, s in (
        (k, torch.sum(torch.square(g.float()))) for k, g in grads.items()))
    if mesh.size > 1:
        sq = all_reduce(sq, mesh.axis(*mesh.axis_names))
    return torch.sqrt(sq)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads: Named, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled so their global L2 norm is at most ``max_norm``, in
    their own dtypes; the norm before clipping)."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {k: _clipped(g, scale) for k, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(grads: Named, state: Dict[str, object], params: Named, lr,
                 cfg: AdamWConfig, gnorm: Optional[torch.Tensor] = None):
    """One clipped AdamW step, in place -> (params, state, gnorm).

    ``lr`` is a float or a 0-d tensor (``warmup_cosine``'s).  The moments
    and the decoupled weight decay act on the f32 master (or on the
    parameter itself without one); a bf16 parameter is the master rounded
    to its dtype.  ``gnorm``: the global norm when the gradients are
    shards (``sharded_global_norm``), else computed here."""
    gn = _global_norm(grads) if gnorm is None else gnorm
    scale = _clip_scale(gn, cfg.clip_norm)
    state["step"].add_(1)
    t = state["step"].float()
    c1, c2 = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
    lr = lr.to(gn.device) if isinstance(lr, torch.Tensor) else lr
    master = state.get("master") if cfg.master_weights else None
    for k, p in params.items():
        g = _clipped(grads[k], scale).float()
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        base = master[k] if master is not None else p
        pf = base.float()           # ``base`` itself when it is f32
        u = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        pf.sub_(lr * (u + cfg.weight_decay * pf))
        if pf is not p:
            p.copy_(pf)
    return params, state, gn
