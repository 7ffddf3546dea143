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
checkpoint with the data cursor.  ``--mesh`` (sharded training) raises
``NotImplementedError``: it comes with ROADMAP A4.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

from torch import nn

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData, to_device
from repro_torch.launch.steps import make_train_step, named_params
from repro_torch.models import init_model
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_init


@dataclasses.dataclass
class TrainRun:
    """What ``train_loop`` returns: the loss of each step it ran, each
    step's wall seconds (host clock, ending in the loss's read-back), the
    trained model and optimizer state."""
    losses: List[float]
    step_seconds: List[float]
    model: nn.Module
    opt_state: Dict[str, object]
    cfg: ArchConfig


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
               enc_layers: Optional[int] = None) -> TrainRun:
    """Train ``arch`` from ``init_model``'s draw from ``seed`` for
    ``steps`` steps (from the newest checkpoint in ``ckpt_dir`` when there
    is one) -> ``TrainRun``.  ``n_layers`` / ``enc_layers`` cut the depth
    (``cut_depth``)."""
    if use_mesh:
        raise NotImplementedError("sharded training (--mesh) comes with "
                                  "ROADMAP A4 (distribution)")
    device = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if smoke:
        cfg = cfg.replace(grad_accum=1)
    cfg = cut_depth(cfg, n_layers, enc_layers)
    ocfg = AdamWConfig(master_weights=cfg.dtype == "bfloat16")
    step_fn = make_train_step(cfg, ocfg, base_lr=base_lr)
    data = SyntheticLMData(cfg, batch, seq, seed=seed)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    model = init_model(cfg, seed=seed, device=device)
    opt_state = adamw_init(named_params(model), ocfg)
    step0 = 0
    if mgr is not None and mgr.latest_step() is not None:
        _, meta = mgr.restore(mgr.latest_step(), (model, opt_state))
        step0 = meta["step"]
        data.restore(meta.get("data_state", step0))
        print(f"resumed from step {step0}", flush=True)

    t0 = time.perf_counter()
    losses: List[float] = []
    durations: List[float] = []
    saved = None
    try:
        for step in range(step0, steps):
            ts = time.perf_counter()
            b = to_device(next(data), device)
            model, opt_state, metrics = step_fn(model, opt_state, b, step)
            losses.append(float(metrics["loss"]))
            # straggler detection: a step far beyond the running median
            dt_step = time.perf_counter() - ts
            durations.append(dt_step)
            med = sorted(durations)[len(durations) // 2]
            if len(durations) >= 5 and dt_step > 3.0 * med:
                print(f"[straggler] step {step + 1} took {dt_step * 1e3:.0f}"
                      f" ms (median {med * 1e3:.0f} ms)", flush=True)
            if (step + 1) % log_every == 0:
                dt = (time.perf_counter() - t0) / max(step - step0 + 1, 1)
                print(f"step {step + 1}: loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['gnorm']):.3f} "
                      f"({dt * 1e3:.0f} ms/step)", flush=True)
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, (model, opt_state),
                         extra={"data_state": data.state()})
                saved = step + 1
        if mgr is not None:
            if saved == steps:        # the last save is this step's: drain it
                mgr.wait()
            else:
                mgr.save(steps, (model, opt_state),
                         extra={"data_state": data.state()}, blocking=True)
    finally:
        if mgr is not None:
            mgr.close()
    return TrainRun(losses, durations, model, opt_state, cfg)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = train_loop(args.arch, args.smoke, args.steps, args.batch, args.seq,
                     args.ckpt_dir, args.ckpt_every, use_mesh=args.mesh,
                     base_lr=args.lr, device=args.device)
    if run.losses:
        print(f"final loss {run.losses[-1]:.4f} (start {run.losses[0]:.4f})")


if __name__ == "__main__":
    main()
