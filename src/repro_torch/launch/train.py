"""Training driver with checkpoint / resume (counterpart of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir DIR

runs SR-STE training steps of any arch on the card (``--device cuda``,
the default; ``--device cpu`` runs the plain path): the synthetic data
stream (tokens, the vlm family's embeddings, the audio family's encoder
frames), gradient
accumulation (``cfg.grad_accum``; 1 under ``--smoke``), AdamW with f32
master weights for a bf16 model, a checkpoint every ``--ckpt-every`` steps
and a blocking one at the end, and resume from the newest complete
checkpoint with the data cursor.

``--mesh`` trains on a (data, model) mesh over a ``torch.distributed``
group, ``choose_mesh(prefer_model=2)`` over its ranks as the reference's
launcher does (``launch.steps``: FSDP over "data", the row layout over
"model" for every family, the attention's and the mixers' heads and
channels split; whisper's ``"fulldp"`` replicates the weights and spreads
the batch).  The accumulation depth is
clamped so that each microbatch covers the batch ranks.  ``--ranks N``
starts N local processes itself (a localhost group); ``--distributed``
joins a group started elsewhere (``--coordinator host:port
--num-processes N --process-id R``, or the torchrun environment).
``--backend``: nccl on cards (one card a rank), gloo on the CPU, or gloo
for several ranks on one card (staged through host memory).  Rank 0
prints and writes the checkpoints, gathered whole: a checkpoint written
under one mesh resumes under another, or in one process.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 4 --batch 8 --seq 16 --mesh --ranks 4 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.checkpoint import (CheckpointManager, gather_state,
                                    shard_state)
from repro_torch.configs import get_config
from repro_torch.data import (SyntheticLMData, accum_for_mesh, local_batch,
                              to_device)
from repro_torch.launch.steps import make_train_step, named_params
from repro_torch.models import init_model, shard_for_training
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_init


@dataclasses.dataclass
class TrainRun:
    """What ``train_loop`` returns: the loss of each step it ran, each
    step's wall seconds (host clock, ending in the loss's read-back), the
    trained model and optimizer state (under a mesh: this rank's
    skeleton and shards, with ``layouts``, the ``mesh`` and each step's
    gradient norm)."""
    losses: List[float]
    step_seconds: List[float]
    model: nn.Module
    opt_state: Dict[str, object]
    cfg: ArchConfig
    mesh: object = None
    layouts: Optional[Dict[str, object]] = None
    gnorms: List[float] = dataclasses.field(default_factory=list)
    accum: int = 1


def cut_depth(cfg: ArchConfig, n_layers: Optional[int] = None,
              enc_layers: Optional[int] = None) -> ArchConfig:
    """``cfg`` cut to ``n_layers`` blocks (the audio family: decoder
    blocks; ``enc_layers`` cuts its encoder), keeping each family's
    structure: gemma2 whole local / global pairs (an even count), the
    hybrid whole groups of ``attn_period`` Mamba blocks (with its shared
    block), MoE its ``first_dense_layers`` and at least one MoE block.  A
    cut that breaks the structure raises ``ValueError``."""
    if enc_layers is not None:
        if cfg.family != "audio" or enc_layers < 1:
            raise ValueError(f"{cfg.name}: enc_layers={enc_layers} needs the "
                             f"audio family and at least one block")
        cfg = cfg.replace(enc_layers=enc_layers)
    if n_layers is None:
        return cfg
    need = {"gemma2 keeps whole local / global pairs":
            cfg.local_global_period and n_layers % 2,
            "the hybrid keeps whole groups of attn_period blocks":
            cfg.family == "hybrid" and n_layers % (cfg.attn_period or 1),
            "MoE keeps first_dense_layers and one MoE block":
            cfg.family == "moe" and n_layers <= cfg.first_dense_layers}
    broken = [why for why, bad in need.items() if bad]
    if n_layers < 1 or broken:
        raise ValueError(f"{cfg.name}: cannot cut to n_layers={n_layers}"
                         + (f" ({broken[0]})" if broken else ""))
    return cfg.replace(n_layers=n_layers)


def train_loop(arch: str, smoke: bool, steps: int, batch: int, seq: int,
               ckpt_dir: str, ckpt_every: int = 20, seed: int = 0,
               use_mesh: bool = False, log_every: int = 10,
               base_lr: float = 3e-4, device="cuda",
               n_layers: Optional[int] = None,
               enc_layers: Optional[int] = None, mesh=None,
               pregather_fsdp: bool = False,
               backend: Optional[str] = None, cfg: Optional[ArchConfig] = None
               ) -> TrainRun:
    """Train ``arch`` from ``init_model``'s draw from ``seed`` for
    ``steps`` steps (from the newest checkpoint in ``ckpt_dir`` when there
    is one) -> ``TrainRun``.  ``n_layers`` / ``enc_layers`` cut the depth
    (``cut_depth``).  ``use_mesh`` trains on ``mesh`` (default:
    ``choose_mesh(prefer_model=2)`` over this process group, a group of
    one started here when there is none; ``backend`` its backend);
    ``pregather_fsdp`` gathers the FSDP shards once a step.  ``cfg``
    replaces the registry's (before the smoke and depth cuts)."""
    device = resolve_device(device)
    cfg = cfg if cfg is not None else get_config(arch, smoke=smoke)
    if smoke:
        cfg = cfg.replace(grad_accum=1)
    cfg = cut_depth(cfg, n_layers, enc_layers)
    if not use_mesh:
        return _train(cfg, steps, batch, seq, ckpt_dir, ckpt_every, seed,
                      log_every, base_lr, device, None, False)
    from repro_torch.dist.api import axis_rules, train_rules_for
    from repro_torch.dist.elastic import choose_mesh
    if mesh is None:
        mesh = choose_mesh(prefer_model=2, backend=backend, device=device)
    with axis_rules(mesh, train_rules_for(cfg, mesh)):
        return _train(cfg, steps, batch, seq, ckpt_dir, ckpt_every, seed,
                      log_every, base_lr, mesh.device, mesh, pregather_fsdp)


def _train(cfg: ArchConfig, steps: int, batch: int, seq: int, ckpt_dir: str,
           ckpt_every: int, seed: int, log_every: int, base_lr: float,
           device, mesh, pregather: bool) -> TrainRun:
    """``train_loop``'s loop, inside the mesh's rules when there is one."""
    from repro_torch.dist.api import batch_axis
    ocfg = AdamWConfig(master_weights=cfg.dtype == "bfloat16")
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    group = batch_axis() if mesh is not None else None
    accum = cfg.grad_accum if group is None else accum_for_mesh(
        cfg.grad_accum, batch, group.size)
    data = SyntheticLMData(cfg, batch, seq, seed=seed)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    latest = mgr.latest_step() if mgr is not None else None
    model = init_model(cfg, seed=seed, device=device)
    opt_state = None
    step0 = 0
    if latest is not None:        # every rank reads the whole checkpoint
        opt_state = adamw_init(named_params(model), ocfg)
        _, meta = mgr.restore(latest, (model, opt_state))
        step0 = meta["step"]
        data.restore(meta.get("data_state", step0))
        say(f"resumed from step {step0}", flush=True)
    layouts = None
    if mesh is not None:
        model, layouts = shard_for_training(model, mesh)
        if opt_state is not None:
            opt_state = shard_state(layouts, opt_state, mesh)
    if opt_state is None:
        opt_state = adamw_init(named_params(model), ocfg)
    step_fn = make_train_step(cfg, ocfg, base_lr=base_lr, accum=accum,
                              param_specs=layouts, pregather_fsdp=pregather)

    def save(step: int, blocking: bool = False) -> None:
        tree = (model, opt_state) if mesh is None else gather_state(
            model, layouts, opt_state, mesh)
        if mgr is not None and lead:
            mgr.save(step, tree, extra={"data_state": data.state()},
                     blocking=blocking)

    t0 = time.perf_counter()
    losses: List[float] = []
    gnorms: List[float] = []
    durations: List[float] = []
    saved = None
    try:
        for step in range(step0, steps):
            ts = time.perf_counter()
            b = next(data)
            if mesh is not None:
                b = local_batch(b, accum)
            model, opt_state, metrics = step_fn(model, opt_state,
                                                to_device(b, device), step)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["gnorm"]))
            # straggler detection: a step far beyond the running median
            dt_step = time.perf_counter() - ts
            durations.append(dt_step)
            med = sorted(durations)[len(durations) // 2]
            if len(durations) >= 5 and dt_step > 3.0 * med:
                say(f"[straggler] step {step + 1} took {dt_step * 1e3:.0f}"
                    f" ms (median {med * 1e3:.0f} ms)", flush=True)
            if (step + 1) % log_every == 0:
                dt = (time.perf_counter() - t0) / max(step - step0 + 1, 1)
                say(f"step {step + 1}: loss={losses[-1]:.4f} "
                    f"gnorm={gnorms[-1]:.3f} "
                    f"({dt * 1e3:.0f} ms/step)", flush=True)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                save(step + 1)
                saved = step + 1
        if ckpt_dir:
            if saved == steps:        # the last save is this step's: drain it
                if mgr is not None:
                    mgr.wait()
            else:
                save(steps, blocking=True)
    finally:
        if mgr is not None:
            mgr.close()
    return TrainRun(losses, durations, model, opt_state, cfg, mesh, layouts,
                    gnorms, accum)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", action="store_true",
                    help="train on a (data, model) mesh over the process "
                         "group (choose_mesh(prefer_model=2))")
    ap.add_argument("--ranks", type=int, default=0,
                    help="with --mesh: start N local ranks (a localhost "
                         "group), one process each")
    ap.add_argument("--pregather", action="store_true",
                    help="with --mesh: gather the FSDP shards once a step")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on the "
                         "card, gloo with --device cpu)")
    ap.add_argument("--distributed", action="store_true",
                    help="join a process group started elsewhere: from "
                         "--coordinator/--num-processes/--process-id, else "
                         "the torchrun environment")
    ap.add_argument("--coordinator", default=None,
                    help="with --distributed: rendezvous host:port")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="with --distributed: total process count")
    ap.add_argument("--process-id", type=int, default=None,
                    help="with --distributed: this process's rank")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if (args.ranks or args.distributed or args.pregather) and not args.mesh:
        raise SystemExit("--ranks/--distributed/--pregather need --mesh")
    if args.ranks > 1 and not args.distributed:
        import torch.multiprocessing as mp
        from repro_torch.dist.api import free_port
        mp.start_processes(_rank_main, args=(argv, args.ranks, free_port()),
                           nprocs=args.ranks, start_method="spawn")
        return
    ctx = contextlib.nullcontext()
    if args.distributed:
        from repro_torch.dist.api import init_from_env
        backend = args.backend or ("gloo" if args.device == "cpu"
                                   else "nccl")
        if args.device == "cpu" and args.num_processes:
            # each rank takes its share of the cores for its intra-op
            # threads (every rank on every core oversubscribes them)
            torch.set_num_threads(
                max(1, (os.cpu_count() or 1) // args.num_processes))
        init_from_env(backend, args.coordinator, args.num_processes,
                      args.process_id)
        ctx = _group_session()
    with ctx:
        run = train_loop(args.arch, args.smoke, args.steps, args.batch,
                         args.seq, args.ckpt_dir, args.ckpt_every,
                         use_mesh=args.mesh, base_lr=args.lr,
                         device=args.device, pregather_fsdp=args.pregather,
                         backend=args.backend)
        if run.losses and (run.mesh is None or run.mesh.rank == 0):
            print(f"final loss {run.losses[-1]:.4f} (start "
                  f"{run.losses[0]:.4f})"
                  + (f" on mesh {run.mesh.shape}" if run.mesh else ""))


@contextlib.contextmanager
def _group_session():
    """The joined group's life: every rank passes a barrier before the
    group is destroyed (no rank tears down while a peer still talks)."""
    import torch.distributed as dist
    try:
        yield
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, argv, n: int, port: int) -> None:
    """One rank of ``--ranks N``: this command again, joined to the
    group."""
    main(list(argv) + ["--distributed", "--coordinator",
                       f"127.0.0.1:{port}", "--num-processes", str(n),
                       "--process-id", str(rank)])


if __name__ == "__main__":
    main()
