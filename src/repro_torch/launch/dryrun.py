"""Multi-pod dry-run: one rank's step of every (arch x shape x mesh) cell
on an abstract mesh (counterpart of ``repro.launch.dryrun``).

For each cell this builds the rank's ``meta`` parameters, optimizer
state, caches and inputs (nothing is allocated), runs the train,
prefill or decode step once on the abstract 16x16 or 2x16x16 mesh
(``launch.mesh``) under ``launch.op_cost``, and records:
  memory   — argument_size_in_bytes: the rank's parameters, optimizer
             state, caches and inputs, counted exactly;
             temp_size_in_bytes: the peak of the step's live
             intermediates (an estimate, ``op_cost``);
  hlo_cost — the ``op_cost`` dict: FLOPs, bytes, collective bytes by
             type, op counts;
  roofline — the three terms at the H100's published peaks
             (``launch.roofline``): counts over peaks, not measurements.

``lower_s`` / ``compile_s`` keep the reference's keys: the seconds to
build the rank's state and to run the step.  The port's sharded layout
differs from the reference's by design (rows over "model" everywhere,
the embedding and 1-D leaves split over "data", the decode caches'
sequence whole), so per-device bytes and collective bytes are the
port's own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh both --out results/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.dist.api import (DEFAULT_RULES, MULTIPOD_RULES, axis_rules,
                                  make_shardings)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import (RooflineTerms, model_flops_for,
                                         param_counts_exact,
                                         sparse_weight_bytes)
from repro_torch.launch.shapes import ALL_SHAPES, SHAPES, cell_supported
from repro_torch.models.transformer import shard_for_training
from repro_torch.optim import AdamWConfig


def tensor_bytes(*trees) -> int:
    """The bytes of every distinct tensor in ``trees`` (dicts, lists,
    modules)."""
    seen, total = set(), 0

    def visit(x):
        nonlocal total
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                visit(t)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            total += x.numel() * x.element_size()

    for t in trees:
        visit(t)
    return total


def _cut(tree, shardings):
    return {k: _cut(v, shardings[k]) if isinstance(v, dict)
            else shardings[k](v) for k, v in tree.items()}


def cell_rules(cfg, shape, multi_pod: bool,
               rules_update: Dict[str, Any] | None = None):
    """The reference dry-run's rule choice for one cell."""
    rules = dict(MULTIPOD_RULES if multi_pod else DEFAULT_RULES)
    # tp-only serving pays off when the batch amortizes the replicated
    # weight read; at batch=1 (long_500k) 2D sharding spreads the weight
    # stream over all cards (the reference's measured layout policy)
    if (shape.kind != "train" and cfg.serve_layout == "tp"
            and shape.batch >= 8):
        rules["fsdp"] = None
    if shape.kind == "train" and cfg.train_layout == "fulldp":
        rules.update(act_batch=(("pod", "data", "model") if multi_pod
                                else ("data", "model")),
                     fsdp=None, tp=None, act_heads=None, act_vocab=None,
                     act_seq_sp=None, act_ep=None)
    if rules_update:
        rules.update(rules_update)
    return rules


def build_cell(cfg, shape, mesh, rules, pregather: bool = False):
    """(step function, its arguments, the whole ``meta`` model, extra
    record fields) of one rank under the active ``axis_rules``."""
    extra: Dict[str, Any] = {}
    if shape.kind == "train":
        model, specs, _ = steps_mod.abstract_params(cfg)
        skeleton, layouts = shard_for_training(model, mesh)
        ocfg = AdamWConfig()
        opt, _ = steps_mod.abstract_opt_state(skeleton, ocfg, specs)
        bshapes, bspecs = steps_mod.train_input_specs(cfg, shape.batch,
                                                      shape.seq)
        dp = math.prod(mesh.shape[ax] for ax in (rules.get("act_batch")
                                                 or ()) if ax in mesh.shape)
        accum = max(1, min(cfg.grad_accum, shape.batch // max(dp, 1)))
        extra["grad_accum"] = accum
        batch = _cut(bshapes, make_shardings(bspecs, mesh, rules, bshapes))
        step_fn = steps_mod.make_train_step(cfg, ocfg, param_specs=layouts,
                                            accum=accum,
                                            pregather_fsdp=pregather)
        return step_fn, (skeleton, opt, batch, 0), model, extra
    model, _, cserve = steps_mod.abstract_params(cfg, serve=True)
    skeleton, layouts = shard_for_training(model, mesh, serve=True)
    if shape.kind == "prefill":
        bshapes, bspecs = steps_mod.train_input_specs(cserve, shape.batch,
                                                      shape.seq)
        bshapes.pop("labels")
        bspecs.pop("labels")
        batch = _cut(bshapes, make_shardings(bspecs, mesh, rules, bshapes))
        step_fn = steps_mod.make_prefill_step(cserve, param_specs=layouts)
        return step_fn, (skeleton, batch), model, extra
    caches, _ = steps_mod.abstract_caches(cserve, shape.batch, shape.seq)
    caches = steps_mod.local_caches(caches, mesh, rules)
    ishapes, ispecs = steps_mod.decode_input_specs(cserve, shape.batch)
    tokens = make_shardings(ispecs["tokens"], mesh, rules,
                            ishapes["tokens"])(ishapes["tokens"])
    step_fn = steps_mod.make_decode_step(cserve, param_specs=layouts)
    return step_fn, (skeleton, caches, tokens, ishapes["pos"]), model, extra


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save_hlo: str = "", mutate=None,
             rules_update: Dict[str, Any] | None = None,
             pregather: bool = False) -> Dict[str, Any]:
    """mutate: optional cfg -> cfg transform (hillclimb variants);
    rules_update: logical-rule overrides (e.g. {'fsdp': None} for TP-only
    serving); pregather: gather-once FSDP accumulation.  ``save_hlo``
    writes the step's counted ops (name and bytes, one a line) in place
    of HLO text."""
    cfg = get_config(arch)
    if mutate is not None:
        cfg = mutate(cfg)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
    }
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = cell_rules(cfg, shape, multi_pod, rules_update)
    chips = mesh.size
    t0 = time.time()
    with axis_rules(mesh, rules):
        step_fn, args, model, extra = build_cell(cfg, shape, mesh, rules,
                                                 pregather)
        rec.update(extra)
        arg_bytes = tensor_bytes(args)
        t_lower = time.time() - t0
        with OpCost(mesh, record_ops=bool(save_hlo)) as cost:
            step_fn(*args)
        t_compile = time.time() - t0 - t_lower
    hc = cost.result()
    if save_hlo:
        with open(save_hlo, "w") as f:
            f.writelines(f"{name} {b}\n" for name, b in cost.ops)

    n_total, n_active = param_counts_exact(model, cfg)
    mf = model_flops_for(cfg, shape.kind, shape.batch, shape.seq, n_active)
    terms = RooflineTerms(
        flops=hc["flops"],
        bytes_accessed=hc["bytes"],
        collective_bytes=hc["collective_bytes"],
        chips=chips, model_flops=mf)
    sw = sparse_weight_bytes(model, cfg.sparsity)
    rec.update(
        status="OK",
        chips=chips,
        lower_s=round(t_lower, 1), compile_s=round(t_compile, 1),
        params_total=n_total, params_active=n_active,
        hlo_cost={k: hc[k] for k in
                  ("flops", "bytes", "collective_bytes",
                   "collectives_by_type", "op_counts", "loops")},
        xla_cost_raw={},
        memory={"argument_size_in_bytes": int(arg_bytes),
                "temp_size_in_bytes": int(cost.peak)},
        roofline=terms.as_dict(),
        sparse_weights=sw,
    )
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--save-hlo", default="")
    args = ap.parse_args()

    archs = ALL_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = ALL_SHAPES if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, mp, save_hlo=args.save_hlo)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                records.append(rec)
                st = rec["status"]
                extra = ""
                if st == "OK":
                    r = rec["roofline"]
                    extra = (f" dom={r['dominant']} "
                             f"frac={r['roofline_fraction']:.3f} "
                             f"compile={rec['compile_s']}s")
                elif st == "FAIL":
                    extra = " " + rec["error"][:120]
                print(f"[{st}] {tag}{extra}", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    n_ok = sum(r["status"] == "OK" for r in records)
    n_skip = sum(r["status"] == "SKIP" for r in records)
    n_fail = sum(r["status"] == "FAIL" for r in records)
    print(f"\nDONE: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL -> {args.out}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
