"""End-to-end training run (counterpart of ``examples/train_sparse_lm.py``):
train an N:M-sparse LM with the full stack (data pipeline -> SR-STE sparse
model -> AdamW -> checkpoint/restart).

Presets:
  demo  (default) ~4M params, a CPU smoke run in about a minute
  100m            ~100M-param llama-style model, a few hundred steps

  PYTHONPATH=src python -m repro_torch.examples.train_sparse_lm \\
      --preset demo --steps 60 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop


def preset_cfg(name: str):
    base = get_config("llama3.2-1b", smoke=True)
    if name == "demo":
        return base.replace(n_layers=4, d_model=256, n_heads=8, n_kv=4,
                            d_ff=1024, vocab=2048)
    if name == "100m":
        # ~100M params: 12L x d768 (llama-style), 32k vocab
        return base.replace(n_layers=12, d_model=768, n_heads=12, n_kv=4,
                            d_ff=2048, vocab=32768, head_dim=64)
    raise SystemExit(f"unknown preset {name}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="demo", choices=["demo", "100m"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    run = train_loop("preset", smoke=False, steps=args.steps,
                     batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=25, log_every=10, base_lr=1e-3,
                     device=args.device, cfg=preset_cfg(args.preset))
    losses = run.losses
    print(f"\npreset={args.preset}: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f} over {len(losses)} steps (resume-capable via "
          f"{args.ckpt_dir})")
    return run


if __name__ == "__main__":
    main()
