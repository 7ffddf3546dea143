#!/usr/bin/env python
"""How far an arch's f32 training gradient at init lies from its exact
value, and how sensitive the exact value is to its inputs: on the CPU, the
port only.

One batch of ``SyntheticLMData`` (seed 0) through ``loss_and_grads`` of a
model drawn from seed 0 at a chosen width and depth, four ways:

* f32 in one process;
* f32 on a (1, 2) "model" mesh, two gloo ranks forked here (the sharded
  step's gradient, gathered whole);
* f64, in a child process whose ``torch.float32`` and ``Tensor.float``
  stand for f64, so the port's f32 casts widen (the same weights);
* f64 again with each ``--perturb`` group's leaves scaled by
  ``1 + u``, u uniform in +-2^-24 (one f32 rounding).

Prints the loss and gradient norm of each, and for every leaf the largest
difference of the two f32 gradients from the f64 one, relative to the
leaf's largest element (the worst ``--top`` leaves by the sharded one's);
then, per perturbed group, the median and worst leaf's move of the f64
gradient.  Run from the repo root:

    python tools/grad_conditioning.py --arch zamba2-7b --d 448 --layers 6

Widths: ``--d`` sets d_model, the heads (head_dim kept), d_ff = 4d,
d_inner = 2d and the SSM heads (64 channels each); the vocab is 8000.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def config(args):
    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    kw = dict(dtype="float32", n_layers=args.layers, d_model=args.d,
              d_ff=4 * args.d, vocab=8000, grad_accum=1)
    if cfg.n_heads:
        hd = cfg.head_dim or cfg.d_model // cfg.n_heads
        kw.update(n_heads=args.d // hd, n_kv=min(cfg.n_kv, args.d // hd))
    if cfg.ssm_state:
        kw.update(d_inner=2 * args.d,
                  ssm_heads=2 * args.d // 64 if cfg.ssm_heads else None,
                  dt_rank=args.d // 16 if cfg.dt_rank else None)
    return cfg.replace(**kw)


def grads(args, model=None, mesh=None):
    """(loss, {leaf: f64 gradient}) of the batch; ``mesh``: a (1, 2)
    training mesh over this process group."""
    import torch
    from repro_torch.data import SyntheticLMData, local_batch, to_device
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_model
    cfg = config(args)
    model = model if model is not None else init_model(cfg, seed=0,
                                                       device="cpu")
    data = SyntheticLMData(cfg, args.batch, args.seq, seed=0).batch_at(0)
    if mesh is None:
        loss, g = loss_and_grads(model, cfg, to_device(data, "cpu"))
        return float(loss), {k: v.detach().double() for k, v in g.items()}
    from repro_torch.dist.api import axis_rules, train_rules_for
    from repro_torch.models import shard_for_training
    from repro_torch.models.transformer import gather_leaf
    with axis_rules(mesh, train_rules_for(cfg, mesh)):
        skel, lay = shard_for_training(model, mesh)
        loss, g = loss_and_grads(skel, cfg,
                                 to_device(local_batch(data), "cpu"), 1, lay)
        return float(loss), {k: gather_leaf(v.detach(), lay[k].spec, mesh)
                             .double() for k, v in g.items()}


def _rank(rank, args, port, out):
    import torch
    import torch.distributed as dist
    from repro_torch.dist.api import make_train_mesh
    torch.set_num_threads(args.threads)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        res = grads(args, mesh=make_train_mesh((1, 2), backend="gloo",
                                               device="cpu"))
        if rank == 0:
            torch.save(res, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def f64_child(args, init, out):
    """The f64 runs, in this process (a child: it rebinds torch.float32)."""
    import torch
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(args.threads)
    from repro_torch.models import init_model
    whole = torch.load(init)
    res = {}
    for group in [None] + args.perturb:
        model = init_model(config(args), seed=0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(whole[k])
                if group is not None and k.startswith(group):
                    p.mul_(1 + 2.0 ** -24 * (2 * torch.rand(
                        p.shape, generator=gen) - 1))
        res[group] = grads(args, model)
    torch.save(res, out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--d", type=int, default=448)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--perturb", nargs="*", default=[
        "embed.emb", "groups.0.0.mixer.in_proj", "groups.0.0.mixer.out_proj",
        "groups.0.2.mixer.in_proj", "groups.0.4.mixer.out_proj", "lnf"])
    ap.add_argument("--f64-child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.f64_child:
        return f64_child(args, *args.f64_child)
    import torch
    import torch.multiprocessing as mp
    from repro_torch.dist.api import free_port
    from repro_torch.models import init_model
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "tp.pt")
        mp.start_processes(_rank, args=(args, free_port(), out), nprocs=2,
                           start_method="fork")
        l_tp, g_tp = torch.load(out)
        torch.set_num_threads(args.threads)
        init = os.path.join(tmp, "init.pt")
        torch.save({k: p.detach().clone() for k, p in init_model(
            config(args), seed=0, device="cpu").named_parameters()}, init)
        l_one, g_one = grads(args)
        subprocess.run([sys.executable, __file__, *sys.argv[1:],
                        "--f64-child", init, out], check=True)
        exact = torch.load(out)
    l64, g64 = exact.pop(None)

    def norm(g):
        return sum(float(v.pow(2).sum()) for v in g.values()) ** 0.5

    def rel(g, k, ref=g64):
        return float((g[k] - ref[k]).abs().max()) / max(
            float(ref[k].abs().max()), 1e-30)
    n64 = norm(g64)
    print(f"{args.arch} d {args.d}, {args.layers} layers, {args.batch} x "
          f"{args.seq}: f64 loss {l64!r}, gradient norm {n64!r}")
    for name, loss, g in (("f32 one process", l_one, g_one),
                          ("f32 (1, 2) mesh", l_tp, g_tp)):
        errs = [rel(g, k) for k in g64]
        print(f"  {name}: loss {loss - l64:+.3g}, norm rel "
              f"{(norm(g) - n64) / n64:+.3g}; leaves against f64: median "
              f"{statistics.median(errs):.3g}, worst {max(errs):.3g}")
    print(f"  {'leaf':42s} {'max|g|':>9s} {'one':>9s} {'mesh':>9s} "
          f"{'mesh-one':>9s}")
    for k in sorted(g64, key=lambda k: -rel(g_tp, k))[:args.top]:
        print(f"  {k:42s} {float(g64[k].abs().max()):9.3g} "
              f"{rel(g_one, k):9.3g} {rel(g_tp, k):9.3g} "
              f"{rel(g_tp, k, g_one):9.3g}")
    for group, (_, g) in exact.items():
        errs = [rel(g, k) for k in g64]
        print(f"  f64, {group} x (1 +- 2^-24): norm rel "
              f"{(norm(g) - n64) / n64:+.3g}, leaves median "
              f"{statistics.median(errs):.3g}, worst {max(errs):.3g}")


if __name__ == "__main__":
    main()
