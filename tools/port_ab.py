#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port on one NVIDIA card.

  python3 tools/port_ab.py ROOT [--rates] [--spec-twice]

Run it once per checkout, each in its own process and all in one session
on the card (parent, change, change, parent), so that the readings share
the card's clocks and power limit.  ROOT is a checkout's root; the
checkout's own ``chip_smoke.py`` and ``src/repro_torch`` are imported, and
its kernels are built into its own ``src/repro_torch/_build``.  Prints one
JSON line:

* ``paged_gqa_decode_ms`` / ``paged_mla_decode_ms``: one decode-attention
  call at the serving shape (phase 2 of the checkout's ``chip_smoke.py``:
  8 slots, kv_len 1..160, bf16 pools), CUDA events around 50 calls, so
  the wrapper's host time is in it; ``*_device_ms``: the kernel's own
  device time per launch from ``torch.profiler`` over 50 calls.
* ``trash_write``: masked rows of a verify span all write the trash block,
  so several writes name one cell.  The checkout's ``_paged_write_span``
  runs ``trials`` times on the same inputs at the deepseek-v2-lite verify
  shape (8 slots x span 4, six rows masked, latent width 576, bf16) and the
  trash block is compared with what a sequential write in (row, offset)
  order leaves: ``distinct`` outcomes seen and ``sequential`` matches.
* with ``--rates``: ``tokens_per_s`` of full-width llama3.2-1b and
  deepseek-v2-lite-16b through the plain engine (chip_smoke's phase-3/4
  trace, configuration and timed run).
* with ``--spec-twice``: full-width deepseek-v2-lite-16b served twice
  through the speculative engine (chip_smoke's phase-6 trace and
  configuration): ``requests_identical`` of 16 between the two runs and
  each run's counters.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys


def _load_smoke(root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)      # puts ROOT/src first on sys.path
    return mod


def trash_write(torch, trials: int = 200) -> dict:
    from repro_torch.models.attention import _paged_write_span
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, bs, width = 8, 4, 16, 576
    nb = 1 + 2 * (b - 6)
    pool = torch.zeros(nb, bs, width, dtype=torch.bfloat16, device="cuda")
    tbl = torch.zeros(b, 10, dtype=torch.int32, device="cuda")
    tbl[:2, :2] = torch.arange(1, nb, dtype=torch.int32,
                               device="cuda").reshape(2, 2)
    pos = torch.tensor([5, 20] + [0] * (b - 2), dtype=torch.int32,
                       device="cuda")
    upd = torch.randn(b, s, width, generator=gen, device="cuda").to(
        torch.bfloat16)
    want = pool[0].clone()
    for r in range(b):                      # sequential, (row, offset) order
        for i in range(s):
            if r >= 2:
                want[int(pos[r]) + i] = upd[r, i]
    outcomes, sequential = set(), 0
    for _ in range(trials):
        c = {"ckv": pool.clone()}
        _paged_write_span(c, {"ckv": upd}, tbl, pos)
        got = c["ckv"][0]
        outcomes.add(got.float().cpu().numpy().tobytes())
        sequential += int(torch.equal(got, want))
    return dict(trials=trials, distinct=len(outcomes), sequential=sequential)


def device_ms(torch, fn, calls: int = 50) -> float:
    """Device time per launch of the port's paged attention kernel in
    ``fn``, from ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for ev in prof.key_averages():
        if "paged_" in ev.key and "CUDA" in str(getattr(ev, "device_type",
                                                        "")):
            us += getattr(ev, "self_device_time_total", None) or \
                getattr(ev, "self_cuda_time_total", 0.0)
            n += ev.count
    if n != calls:
        raise SystemExit(f"port_ab: traced {n} attention launches, "
                         f"expected {calls}")
    return us / 1e3 / n


def decode_device_ms(torch, smoke) -> dict:
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(6)
    g = smoke._paged_inputs(torch, torch.bfloat16, gen, smoke.SERVE_LENS)
    m = smoke._mla_inputs(torch, torch.bfloat16, gen, smoke.SERVE_LENS)
    scale = (128 + 64) ** -0.5
    return dict(
        paged_gqa_decode_device_ms=device_ms(
            torch, lambda: fa.paged_gqa_decode(*g, scale=0.125)),
        paged_mla_decode_device_ms=device_ms(
            torch, lambda: fa.paged_mla_decode(*m, scale=scale)))


def rates(torch, smoke) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    out = {}
    for arch, path in (("llama3.2-1b", smoke.LLAMA_PATH),
                       ("deepseek-v2-lite-16b", smoke.DEEPSEEK_PATH)):
        cfg = get_config(arch)
        if arch.startswith("deepseek"):
            cfg = cfg.replace(sparsity=dataclasses.replace(
                cfg.sparsity, mode="compressed"))
        model = init_model(cfg, seed=0, device="cuda")
        kw = dict(n_slots=8, max_len=128 + 32, compressed=True, kv="paged",
                  attn="fused", block_size=16, device="cuda")
        eng, _, _, wall = smoke.serve_run(torch, model, cfg, path, kw, arch)
        out[arch] = eng.stats()["tokens"] / wall
        del eng, model
        torch.cuda.empty_cache()
    return dict(tokens_per_s=out)


def serve_twice(torch, smoke) -> dict:
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, SpecConfig, synthetic_trace
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="compressed"))
    model = init_model(cfg, seed=0, device="cuda")
    kw = dict(n_slots=8, max_len=128 + 32, compressed=True, kv="paged",
              attn="fused", block_size=16, device="cuda",
              spec=SpecConfig(k=smoke.SPAN - 1, draft="skip", stride=2))
    reqs = synthetic_trace(cfg, n_requests=16, prompt_len=128,
                           gen_lens=[16, 32], seed=0)
    runs = []
    for _ in range(2):
        eng = ServeEngine(model, cfg, **kw)
        res = eng.run(reqs)
        st = eng.stats()
        runs.append((res, {k: int(st[k]) for k in (
            "decode_steps", "draft_steps", "spec_proposed", "spec_accepted",
            "spec_steps_saved")}))
    same = sum(bool(np.array_equal(runs[0][0][r.rid].tokens,
                                   runs[1][0][r.rid].tokens)) for r in reqs)
    return dict(requests_identical=same, requests=len(reqs),
                counters=[c for _, c in runs])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--rates", action="store_true")
    ap.add_argument("--spec-twice", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("port_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 plain products
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.abspath(args.root)
    smoke = _load_smoke(root)
    smoke.phase_build(torch)
    out = dict(root=root,
               paged_gqa_decode_ms=smoke.phase_attention(torch, F)["ms"],
               paged_mla_decode_ms=smoke.phase_mla_attention(torch, F)["ms"],
               **decode_device_ms(torch, smoke),
               trash_write=trash_write(torch))
    if args.rates:
        out.update(rates(torch, smoke))
    if args.spec_twice:
        out["serve_twice"] = serve_twice(torch, smoke)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
