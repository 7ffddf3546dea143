"""Shared pieces of the port's sharded-training tests (not a test module:
pytest collects nothing here).

``train_on_ranks(tmp_path, n, jobs)`` runs one ``make_train_step`` step
per job on n gloo ranks (``_torch_tp.run_ranks``, one child for all the
jobs) from the smoke model of ``pair(job["arch"])`` (the reference's
weights, f32) on the global batch ``batch(cfg)``; each job names its
arch, mesh shape, accumulation depth and ``pregather_fsdp``, and may
name ``rules="default"`` (``DEFAULT_RULES`` in place of the config's
``train_rules_for``).  A rank returns its loss, gradient norm,
transport counters and optimizer-state bytes; rank 0 also writes the
gathered whole model and AdamW state to ``<tmp>/job<i>.pt``.
``ref_step`` is the reference's unsharded ``make_train_step`` on the same
state and batch, ``port_step`` the port's one-process step."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_engines import pair
from _torch_tp import run_ranks
from repro.launch.steps import make_train_step as jmake_step
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro_torch.convert import to_reference_opt_state, to_reference_tree
from repro_torch.data import SyntheticLMData, to_device
from repro_torch.launch.steps import make_train_step, named_params
from repro_torch.optim import AdamWConfig, adamw_init

LR, WARMUP, STEP = 1e-3, 2, 1
BATCH, SEQ = 8, 16

_STEP = r'''
def body(mesh, jobs_path, out):
    import math
    from repro_torch.checkpoint import gather_state
    from repro_torch.data import local_batch, to_device
    from repro_torch.dist.api import (DEFAULT_RULES, axis_rules,
                                      make_train_mesh, train_rules_for)
    from repro_torch.launch.steps import make_train_step, named_params
    from repro_torch.models import shard_for_training
    from repro_torch.optim import AdamWConfig, adamw_init
    jobs = torch.load(jobs_path, weights_only=False)
    ocfg = AdamWConfig(master_weights=False)
    res = []
    for i, job in enumerate(jobs):
        model, cfg = job["model"]
        tmesh = make_train_mesh(job["shape"], device="cpu")
        rules = (DEFAULT_RULES if job.get("rules") == "default"
                 else train_rules_for(cfg, tmesh))
        with axis_rules(tmesh, rules):
            skel, lay = shard_for_training(model, tmesh)
            opt = adamw_init(named_params(skel), ocfg)
            step = make_train_step(cfg, ocfg, base_lr=%r, warmup=%r,
                                   param_specs=lay, accum=job["accum"],
                                   pregather_fsdp=job["pregather"])
            batch = to_device(local_batch(job["batch"], job["accum"]), "cpu")
            tmesh.reset_stats()
            _, opt, m = step(skel, opt, batch, %r)
            stats = dict(tmesh.stats)
            state = sum(t.numel() * t.element_size() for k in ("mu", "nu")
                        for t in opt[k].values())
            params = sum(p.numel() * p.element_size()
                         for p in skel.parameters())
            whole, wopt = gather_state(skel, lay, opt, tmesh)
        if tmesh.rank == 0:
            torch.save({"params": {k: p.detach() for k, p in
                                   whole.named_parameters()},
                        "mu": wopt["mu"], "nu": wopt["nu"]},
                       f"{out}.job{i}.pt")
        res.append(dict(loss=float(m["loss"]), gnorm=float(m["gnorm"]),
                        stats=stats, state_bytes=state, param_bytes=params,
                        fsdp_model=sum(
                            p.numel() * p.element_size() *
                            (math.prod(tmesh.shape[a] for a in l.split) - 1)
                            for k, p in skel.named_parameters()
                            for l in [lay[k]] if l.split)))
    return res
''' % (LR, WARMUP, STEP)


def batch(cfg, seed=0):
    return SyntheticLMData(cfg, BATCH, SEQ, seed=seed).batch_at(0)


def train_on_ranks(tmp_path, n, jobs):
    """The jobs' results on ranks 0..n-1 (a list per rank, in job order)
    and rank 0's gathered trees."""
    full = []
    for job in jobs:
        _, _, tc, model = pair(job["arch"])
        full.append(dict(job, model=(model, tc), batch=batch(tc)))
    jpath = tmp_path / "jobs.pt"
    torch.save(full, jpath)
    ranks = run_ranks(_STEP, n, tmp_path / "out", jpath, tmp_path / "out")
    trees = [torch.load(f"{tmp_path / 'out'}.job{i}.pt") for i in
             range(len(jobs))]
    return ranks, trees


_JSTEPS = {}


def ref_step(arch, accum):
    """(loss, gnorm, params, mu, nu) of the reference's unsharded step."""
    key = (arch, accum)
    if key not in _JSTEPS:
        jc, params, tc, _ = pair(arch)
        ocfg = JAdamW(master_weights=False)
        fn = jax.jit(jmake_step(jc, ocfg, base_lr=LR, warmup=WARMUP,
                                accum=accum))
        p, o, m = fn(params, jadamw_init(params, ocfg),
                     jax.tree.map(jnp.asarray, batch(tc)), jnp.int32(STEP))
        _JSTEPS[key] = (float(m["loss"]), float(m["gnorm"]), p, o["mu"],
                        o["nu"])
    return _JSTEPS[key]


def port_step(arch, accum):
    """(loss, gnorm) of the port's one-process step."""
    _, _, tc, model = pair(arch)
    model = copy.deepcopy(model)
    ocfg = AdamWConfig(master_weights=False)
    opt = adamw_init(named_params(model), ocfg)
    step = make_train_step(tc, ocfg, base_lr=LR, warmup=WARMUP, accum=accum)
    _, _, m = step(model, opt, to_device(batch(tc), "cpu"), STEP)
    return float(m["loss"]), float(m["gnorm"])


def leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def close_to_reference(arch, tree, jp, jmu, jnu, tol=1e-4):
    """The gathered parameters and AdamW moments within ``tol`` of the
    reference's, parameters held as ``test_torch_train_families_step``
    holds them (an element whose sqrt(nu-hat) is below 1e-6 takes an
    ill-conditioned update, held to 2 lr)."""
    tc = pair(arch)[2]
    got_p = leaves(to_reference_tree(tree["params"], tc))
    st = to_reference_opt_state({"mu": tree["mu"], "nu": tree["nu"],
                                 "step": torch.tensor(STEP)}, tc)
    got_mu, got_nu = leaves(st["mu"]), leaves(st["nu"])
    want_p, want_mu, want_nu = leaves(jp), leaves(jmu), leaves(jnu)
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_mu[k], want_mu[k], rtol=tol, atol=tol,
                                   err_msg=k)
        np.testing.assert_allclose(got_nu[k], want_nu[k], rtol=tol, atol=tol,
                                   err_msg=k)
        ill = np.sqrt(want_nu[k] / (1 - 0.95 ** STEP)) < 1e-6
        np.testing.assert_allclose(got_p[k][~ill], want_p[k][~ill],
                                   rtol=tol, atol=tol, err_msg=k)
        assert np.all(np.abs(got_p[k][ill] - want_p[k][ill])
                      <= 2 * LR + 1e-6), k


def whole_bytes(arch):
    """The whole model's f32 mu + nu bytes."""
    model = pair(arch)[3]
    return 2 * sum(p.numel() * p.element_size() for p in model.parameters())
