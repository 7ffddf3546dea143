"""Continuous-batching serving demo (counterpart of
``examples/serve_continuous.py``): a mixed-length request trace through
the slot-refilling engine, with the fixed-batch loop run on the same
trace for contrast.  Early-finishing slots are re-admitted from the queue
the very next decode tick, so the compressed-weight stream (the
decode-regime cost the paper's N:M format minimizes) is shared by more
useful tokens per pass.

  PYTHONPATH=src python -m repro_torch.examples.serve_continuous \\
      --arch llama3.2-1b [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.serve import ServeEngine, serve_sequential, synthetic_trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-mix", default="12,4,8,3",
                    help="comma list of gen budgets cycled over the trace")
    ap.add_argument("--arrival-every", type=int, default=0)
    ap.add_argument("--impl", default="auto",
                    help="auto | plain | ref | xwt | spmv | spmv_onehot")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    cfg = cfg.replace(sparsity=dataclasses.replace(
        cfg.sparsity, mode="compressed", impl=args.impl))
    model = init_model(cfg, device=dev)

    gen_lens = [int(g) for g in args.gen_mix.split(",")]
    reqs = synthetic_trace(cfg, n_requests=args.requests,
                           prompt_len=args.prompt_len, gen_lens=gen_lens,
                           arrival_every=args.arrival_every)
    max_len = args.prompt_len + max(gen_lens)

    eng = ServeEngine(model, cfg, n_slots=args.slots, max_len=max_len,
                      device=dev)
    results = eng.run(reqs)
    st = eng.stats()
    print(f"arch={args.arch} slots={args.slots} requests={args.requests} "
          f"gens={gen_lens}")
    print(f"continuous: {int(st['tokens'])} tokens / "
          f"{int(st['decode_steps'])} decode steps "
          f"(occupancy {st['occupancy']:.2f})")

    _, sstats = serve_sequential(model, cfg, reqs, args.slots,
                                 max_len=max_len, device=dev)
    print(f"sequential: same trace takes {int(sstats['decode_steps'])} "
          f"decode steps (finished slots idle until the batch drains)")

    for rid in sorted(results)[:4]:
        r = results[rid]
        print(f"  req{rid}: admitted t={r.admitted_at} finished "
              f"t={r.finished_at} tokens {r.tokens[:8].tolist()}")


if __name__ == "__main__":
    main()
