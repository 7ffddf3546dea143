"""Batched serving with compressed N:M weights (counterpart of
``examples/serve_decode.py``): prefill a batch of prompts, then
greedy-decode, the vindexmac regime (decode streams the compressed weight
format; ``kernels/nm_spmv.py`` launches the decode kernel on the card).

Serves the same trace twice, ``--weights dense`` (masked-dense pool) and
``--weights compressed`` (the model packed at engine init, the CLI
equivalent being ``python -m repro_torch.launch.serve --weights
compressed``), and prints the per-decode-step weight-stream bytes of
each.  Tokens are identical; the compressed pool streams about N/M of the
dense bytes plus the packed ceil(log2 M)-bit index words.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
      --arch llama3.2-1b [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.serve import ServeEngine, synthetic_trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--weights", default="both",
                    choices=["dense", "compressed", "both"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    cfg = cfg.replace(sparsity=dataclasses.replace(
        cfg.sparsity, mode="srste", impl="auto"))
    model = init_model(cfg, device=dev)
    reqs = synthetic_trace(cfg, n_requests=args.batch,
                           prompt_len=args.prompt_len, gen_lens=[args.gen])
    max_len = args.prompt_len + args.gen

    kinds = ["dense", "compressed"] if args.weights == "both" \
        else [args.weights]
    tokens = {}
    print(f"arch={args.arch} {cfg.sparsity.n}:{cfg.sparsity.m} "
          f"batch={args.batch} gen={args.gen}")
    for kind in kinds:
        t0 = time.time()
        eng = ServeEngine(model, cfg, n_slots=args.batch, max_len=max_len,
                          compressed=(kind == "compressed"), device=dev)
        results = eng.run(reqs)
        dt = time.time() - t0
        st = eng.stats()
        tokens[kind] = results
        print(f"{kind:>10}: {st['tokens']:.0f} tokens in {dt:6.2f} s | "
              f"weight stream {st['weight_stream_bytes'] / 2**20:8.2f} "
              f"MiB/step ({st['weight_stream_ratio']:.3f}x dense)")
    if len(kinds) == 2:
        match = all(np.array_equal(tokens["dense"][r.rid].tokens,
                                   tokens["compressed"][r.rid].tokens)
                    for r in reqs)
        print(f"token-for-token: {'MATCH' if match else 'MISMATCH'}")
    rid0 = min(tokens[kinds[-1]])
    print("sample:", tokens[kinds[-1]][rid0].tokens[:12].tolist())


if __name__ == "__main__":
    main()
