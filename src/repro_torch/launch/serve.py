"""Serving CLI of the port (counterpart of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --scheduler continuous --weights compressed --kv paged --attn fused

runs the continuous-batching engine on the card (``--device cuda``, the
default; ``--device cpu`` runs the plain path); ``--arch
deepseek-v2-lite-16b`` serves the MoE family with MLA attention.  Weights
are random, from ``--seed``.  Flags of features not ported yet are
accepted and raise ``NotImplementedError`` naming the slice that brings
them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.serve import ServeEngine, synthetic_trace
from repro_torch.serve.engine import not_ported


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["sequential", "continuous"])
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="trace length (default: one batch of --slots)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--gen-mix", default="",
                    help="comma list of gen budgets cycled over the trace")
    ap.add_argument("--arrival-every", type=int, default=0)
    ap.add_argument("--impl", default="auto",
                    help="sparse-matmul impl ('auto': kernels on the card by "
                         "shape, plain on the CPU; 'ref' pins the oracle)")
    ap.add_argument("--weights", default="compressed",
                    choices=["dense", "compressed"])
    ap.add_argument("--kv", default="paged", choices=["slotted", "paged"])
    ap.add_argument("--attn", default="fused", choices=["gather", "fused"])
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=0,
                    help="physical block count incl. the trash block "
                         "(0 = full provisioning)")
    ap.add_argument("--preempt", default="replay",
                    choices=["replay", "suspend"])
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--spec", action="store_true")
    ap.add_argument("--tp", type=int, default=0)
    ap.add_argument("--prewarm", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.scheduler == "sequential":
        raise not_ported("--scheduler sequential", "slotted-cache/sequential-oracle")
    if args.prefix_cache:
        raise not_ported("--prefix-cache", "serve-features")
    if args.spec:
        raise not_ported("--spec", "serve-features")
    if args.tp:
        raise not_ported("--tp", "distribution")

    cfg = get_config(args.arch, smoke=args.smoke)
    # weights are born dense (srste semantics) so both --weights settings
    # serve the same model: 'compressed' packs it offline at engine init
    cfg = cfg.replace(sparsity=dataclasses.replace(
        cfg.sparsity, mode="srste", impl=args.impl))
    model = init_model(cfg, seed=args.seed, device=args.device)
    gen_lens = ([int(g) for g in args.gen_mix.split(",")] if args.gen_mix
                else [args.gen])
    reqs = synthetic_trace(cfg, n_requests=args.requests or args.slots,
                           prompt_len=args.prompt_len, gen_lens=gen_lens,
                           seed=args.seed, arrival_every=args.arrival_every)
    eng = ServeEngine(model, cfg, n_slots=args.slots,
                      max_len=args.prompt_len + max(gen_lens),
                      compressed=args.weights == "compressed", kv=args.kv,
                      block_size=args.block_size,
                      n_blocks=args.blocks or None, attn=args.attn,
                      preempt=args.preempt, prewarm=args.prewarm,
                      device=args.device)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    print(f"continuous[{args.weights},{args.kv},{args.attn}] on "
          f"{eng.device}: {int(st['tokens'])} tokens in "
          f"{int(st['decode_steps'])} decode steps, {wall:.3f}s wall, "
          f"occupancy {st['occupancy']:.2f}, weight stream "
          f"{st['weight_stream_ratio']:.2f}x dense "
          f"({int(st['weight_stream_bytes'])} B/step), "
          f"{int(st['preemptions'])} preemptions, "
          f"{int(st['prefill_calls'])} prefills")
    rid0 = min(results)
    print("sample:", results[rid0].tokens[:12].tolist())


if __name__ == "__main__":
    main()
