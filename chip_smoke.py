#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build: compile the three Hopper kernels of the serving path from
   ``src/repro_torch/csrc`` with nvcc (sm_90a, one nvcc per source, in
   parallel); print the card's name and power limit from nvidia-smi.
2. Kernel vs plain: at the full-width llama3.2-1b main-path shapes, hold
   each kernel against its plain torch version on the card, in float32 and
   bfloat16, and time it beside its bound, the plain version and one
   PyTorch call that computes the same function (the yardstick; the port
   never calls it).
3. Serve: full-width llama3.2-1b (16 layers, d 2048, 32/8 heads, d_ff
   8192, vocab 128256, bf16, 2:4 compressed; random weights from a seed)
   through ``ServeEngine(kv="paged", attn="fused", compressed=True)``: 8
   slots, 16 requests of 128 prompt tokens, generation mix 16/32, block
   size 16.  Every kernel must have launched during the run.  Then the
   same prefills and first decode steps run through the kernel route and
   through the reference route (``impl="ref"``, ``attn="gather"``) and the
   logits are compared.
4. Summary: a ``{"kernels": [...]}`` line, then the device line last.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
# one decode layer's seven linears (out, in): wq, wk, wv, wo, wg, wu, wd
LAYER_SHAPES = [(2048, 2048), (512, 2048), (512, 2048), (2048, 2048),
                (8192, 2048), (8192, 2048), (2048, 8192)]
CHECK_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
N, M = 2, 4
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
ATTN_TOL = 2e-4
# Reference-route check (phase 3): logits are O(1) (unit-RMS final state
# against a table with d^-0.5 rows).  The two routes round every linear's
# output to bf16 at different points and 16 layers compound it, so logits
# may move by a few bf16 steps of the residual; 0.25 bounds that with room
# while still failing on any wrong kernel (those move logits by O(1)).
LOGIT_ATOL = 0.25


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, want, rtol: float, atol: float):
    """(max |got - want|, whether every element is within atol+rtol|want|)."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), False
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= atol + rtol * w.abs()).all())


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 1

def phase_build(torch):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] nvcc {build.nvcc_path()} built {built or 'nothing (cached)'}"
        f" in {time.perf_counter() - t0:.1f}s")
    for name in built:
        for line in build.BUILD_LOG[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)                   # nvidia-smi's own "name, power.limit" line
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return card


# ------------------------------------------------------------------ phase 2

def _compressed(torch, o, k, dtype, gen):
    """A weight drawn as ``linear_init`` draws it (scale k^-0.5), so the
    products are O(1) as in the model; unscaled, an f32 sum over 8192
    terms of size ~64 carries ~1e-3 of rounding noise in either order."""
    from repro_torch.core.sparsity import compress
    w = (torch.randn(o, k, generator=gen, device="cuda") * k ** -0.5).to(dtype)
    return compress(w, N, M)


def phase_matmuls(torch, F):
    """nm_spmv (decode) and nm_xwt (prefill) against their plain versions;
    timings over one decode layer's seven linears (bf16), whose 91 MB of
    compressed weights exceed the 50 MB L2, so each pass streams them."""
    from repro_torch.core.sparsity import decompress
    from repro_torch.kernels import nm_spmm, nm_spmv
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"nm_spmv": 0.0, "nm_xwt": 0.0}
    ok = True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        rtol, atol = TOL[dname]
        for o, k in CHECK_SHAPES:
            sp = _compressed(torch, o, k, dtype, gen)
            for b in (1, 8):
                x = torch.randn(b, k, generator=gen, device="cuda").to(dtype)
                e, good = max_err(torch, nm_spmv.nm_spmv(x, sp.values, sp.indices, N, M),
                                  nm_spmv.nm_spmv_plain(x, sp.values, sp.indices, N, M),
                                  rtol, atol)
                errs["nm_spmv"] = max(errs["nm_spmv"], e)
                ok &= good
                log(f"[check] nm_spmv {dname} B={b} (O,K)=({o},{k}) "
                    f"max_abs_err {e:.3e} tol {atol}+{rtol}|ref| "
                    f"{'ok' if good else 'FAIL'}")
            for s in (4, 128):
                x = torch.randn(s, k, generator=gen, device="cuda").to(dtype)
                e, good = max_err(torch, nm_spmm.nm_xwt(x, sp.values, sp.indices, N, M),
                                  nm_spmm.nm_xwt_plain(x, sp.values, sp.indices, N, M),
                                  rtol, atol)
                errs["nm_xwt"] = max(errs["nm_xwt"], e)
                ok &= good
                log(f"[check] nm_xwt  {dname} S={s} (O,K)=({o},{k}) "
                    f"max_abs_err {e:.3e} tol {atol}+{rtol}|ref| "
                    f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2: a matmul kernel disagrees with its plain "
                         "version")

    layer = [_compressed(torch, o, k, torch.bfloat16, gen)
             for o, k in LAYER_SHAPES]
    dense = [decompress(sp) for sp in layer]
    rows = {}
    for name, fn, plain, b in (
            ("nm_spmv", nm_spmv.nm_spmv, nm_spmv.nm_spmv_plain, 8),
            ("nm_xwt", nm_spmm.nm_xwt, nm_spmm.nm_xwt_plain, 128)):
        xs = {k: torch.randn(b, k, generator=gen, device="cuda").to(
            torch.bfloat16) for k in (2048, 8192)}

        def run(f):
            return lambda: [f(xs[sp.dense_shape[1]], sp.values, sp.indices,
                              N, M) for sp in layer]

        nbytes = sum(b * sp.dense_shape[1] * 2 + sp.values.numel() * 3
                     + b * sp.dense_shape[0] * 2 for sp in layer)
        flops = sum(2.0 * b * sp.values.numel() for sp in layer)
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        ms = time_ms(torch, run(fn))
        plain_ms = time_ms(torch, run(plain), iters=5)
        lib_ms = time_ms(torch, lambda: [F.linear(xs[w.shape[1]], w)
                                         for w in dense])
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                          bound_by=by, library_ms=lib_ms,
                          max_abs_err=errs[name])
        log(f"[time] {name} one layer (7 linears, bf16, "
            f"{'B' if name == 'nm_spmv' else 'S'}={b}): kernel {ms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP), plain {plain_ms:.4f} ms, "
            f"F.linear on the decompressed weight {lib_ms:.4f} ms")
    return rows


def _paged_inputs(torch, dtype, gen, lens, kvh=8, g=4, d=64, bs=16):
    b = len(lens)
    tw = -(-max(lens) // bs)
    nb = b * tw + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tbl = torch.zeros(b, tw, dtype=torch.int32, device="cuda")
    for r, n in enumerate(lens):
        own = -(-n // bs)
        tbl[r, :own] = perm[r * tw:r * tw + own]
    kp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    kp[0] = 1e4                 # hot trash block: the mask must zero it
    vp[0] = 1e4
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tbl, kv_len


def phase_attention(torch, F):
    """paged_gqa_decode at the serving shape: 8 slots, KVH 8, G 4, d 64,
    block 16, ragged kv_len, shuffled table."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    lens = [1, 16, 17, 64, 100, 128, 145, 160]
    worst, ok = 0.0, True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        args = _paged_inputs(torch, dtype, gen, lens)
        for case in (dict(), dict(window=48, cap=30.0)):
            e, good = max_err(torch, fa.paged_gqa_decode(*args, scale=0.125, **case),
                              fa.paged_gqa_decode_plain(*args, scale=0.125, **case),
                              ATTN_TOL, ATTN_TOL)
            worst, ok = max(worst, e), ok and good
            log(f"[check] paged_gqa_decode {dname} {case or 'plain mask'} "
                f"max_abs_err {e:.3e} tol {ATTN_TOL}+{ATTN_TOL}|ref| "
                f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2: paged_gqa_decode disagrees with its plain "
                         "version")
    q, kp, vp, tbl, kv_len = _paged_inputs(torch, torch.bfloat16, gen, lens)
    b, kvh, g, d = q.shape
    length = tbl.shape[1] * kp.shape[1]
    ms = time_ms(torch, lambda: fa.paged_gqa_decode(q, kp, vp, tbl, kv_len,
                                                    scale=0.125), iters=50)
    plain_ms = time_ms(torch, lambda: fa.paged_gqa_decode_plain(
        q, kp, vp, tbl, kv_len, scale=0.125), iters=20)
    # yardstick: SDPA over the K/V gathered into position order (gather and
    # head expansion outside the timed call)
    kr = kp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
    vr = vp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
    kr, vr = kr.transpose(1, 2).contiguous(), vr.transpose(1, 2).contiguous()
    qq = q.reshape(b, kvh * g, 1, d)
    mask = (torch.arange(length, device="cuda")[None, :]
            < kv_len[:, None].long())[:, None, None, :]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kr, vr, attn_mask=mask, scale=0.125), iters=50)
    pos = sum(lens)
    nbytes = (q.numel() * 2 + pos * kvh * 2 * d * 2 + tbl.numel() * 4
              + b * 4 + b * kvh * g * d * 4)
    flops = 2.0 * pos * kvh * g * 2 * d
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"[time] paged_gqa_decode one launch (bf16, 8 slots, kv_len {lens}): "
        f"kernel {ms:.4f} ms, bound {bnd:.5f} ms ({by}, {nbytes / 1e6:.2f} MB),"
        f" plain {plain_ms:.4f} ms, SDPA on gathered K/V {lib_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms, max_abs_err=worst)


# ------------------------------------------------------------------ phase 3

def phase_serve(torch):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, synthetic_trace
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] init {cfg.name}: {cfg.n_layers}L d{cfg.d_model} "
        f"{cfg.n_heads}H/{cfg.n_kv}KV d_ff {cfg.d_ff} vocab {cfg.vocab} "
        f"{cfg.dtype} in {time.perf_counter() - t0:.1f}s")
    gen_lens = [16, 32]
    kw = dict(n_slots=8, max_len=128 + max(gen_lens), compressed=True,
              kv="paged", attn="fused", block_size=16, device="cuda")
    # warm-up (first-call library set-up), not counted
    ServeEngine(model, cfg, **kw).run(synthetic_trace(
        cfg, n_requests=2, prompt_len=128, gen_lens=[2], seed=99))
    reqs = synthetic_trace(cfg, n_requests=16, prompt_len=128,
                           gen_lens=gen_lens, seed=0)
    eng = ServeEngine(model, cfg, **kw)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.all_kernels()}
    st = eng.stats()
    log(f"[serve] {int(st['tokens'])} tokens in {wall:.3f}s = "
        f"{st['tokens'] / wall:.1f} tokens/s; {int(st['decode_steps'])} decode "
        f"steps, {int(st['prefill_calls'])} prefills, occupancy "
        f"{st['occupancy']:.3f}, weight stream {st['weight_stream_ratio']:.4f}x"
        f" dense ({st['weight_stream_bytes'] / 1e9:.3f} GB/step), "
        f"{int(st['preemptions'])} preemptions")
    log(f"[serve] kernel launches in the run: {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"phase 3: a kernel of the path never launched: "
                         f"{launches}")
    want = sum(r.max_new_tokens for r in reqs)
    lens_ok = all(len(results[r.rid].tokens) == r.max_new_tokens
                  and not results[r.rid].rejected for r in reqs)
    if st["tokens"] != want or not lens_ok:
        raise SystemExit(f"phase 3: expected {want} tokens over "
                         f"{len(reqs)} requests, got {st['tokens']}")
    check_reference_route(torch, eng, reqs[:8])
    profile_breakdown(torch, model, cfg, kw)
    return launches


def profile_breakdown(torch, model, cfg, kw):
    """Where the time goes: device time by kernel over a traced engine run
    (8 requests, 128 prompt tokens, 16 generated), against its wall time.
    The trace itself slows the host, so the wall here is not the rate."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeEngine, synthetic_trace
    eng = ServeEngine(model, cfg, **kw)
    reqs = synthetic_trace(cfg, n_requests=8, prompt_len=128, gen_lens=[16],
                           seed=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, kernels = {}, []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue            # host ops: their kernels are counted below
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        name = ev.key
        label = next((k for k in ("nm_spmv", "nm_xwt", "paged_gqa_decode")
                      if k in name), None)
        if label is None:   # cuBLAS on Hopper names its gemms nvjet_*
            low = name.lower()
            label = "cuBLAS gemm (LM head)" if any(
                s in low for s in ("gemm", "cutlass", "nvjet")) else "other"
        groups[label] = groups.get(label, 0.0) + us / 1e3
        kernels.append((us / 1e3, ev.count, name[:60]))
    busy = sum(groups.values())
    if busy <= 0:
        raise SystemExit("profile: the trace recorded no device time")
    parts = ", ".join(f"{k} {v:.2f} ms" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"[profile] traced run ({eng.stats()['decode_steps']:.0f} decode "
        f"steps, {eng.prefill_calls} prefills): wall {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%): "
        f"{parts}")
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        log(f"[profile]   {ms:9.2f} ms  {count:6d}x  {name}")


def check_reference_route(torch, eng, reqs, n_steps: int = 4):
    """The engine's prefills and first decode steps through the kernel
    route and through the reference route (impl='ref' decompress + f32
    product, attn='gather'), both teacher-forced with the kernel route's
    greedy tokens; logits must agree within LOGIT_ATOL."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import BlockPool
    cfg = eng.cfg
    ref_cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                       impl="ref"))
    n = len(reqs)
    plen = reqs[0].prompt_len
    pools = {r: BlockPool(cfg, n, plen + n_steps, 16, device="cuda")
             for r in ("kernel", "ref")}
    worst, agree, total = 0.0, 0, 0
    first = []
    for slot, req in enumerate(reqs):
        batch = {"tokens": torch.tensor(req.inputs["tokens"][None],
                                        dtype=torch.long, device="cuda")}
        out = {}
        for route, c in (("kernel", cfg), ("ref", ref_cfg)):
            pool = pools[route]
            pool.alloc(slot, pool.blocks_for(plen))
            out[route], pf = prefill(eng.model, c, batch)
            pool.seed(slot, pf, plen)
        worst = max(worst, float((out["kernel"] - out["ref"]).abs().max()))
        agree += int(out["kernel"].argmax() == out["ref"].argmax())
        total += 1
        first.append(int(out["kernel"].argmax()))
        if not bool(torch.isfinite(out["kernel"]).all()):
            raise SystemExit("phase 3: non-finite prefill logits")
    tok = torch.tensor(first, dtype=torch.long, device="cuda")
    pos = torch.full((n,), plen, dtype=torch.int32, device="cuda")
    for _ in range(n_steps):
        logits = {}
        for route, c, attn in (("kernel", cfg, "fused"),
                               ("ref", ref_cfg, "gather")):
            pool = pools[route]
            for slot in range(n):
                pool.ensure(slot, int(pos[slot]))
            logits[route], _ = decode_step(eng.model, c, pool.caches, tok, pos,
                                           pool.device_table(),
                                           attn_impl=attn)
        lk, lr = logits["kernel"], logits["ref"]
        if tuple(lk.shape) != (n, cfg.vocab) or not bool(torch.isfinite(lk).all()):
            raise SystemExit(f"phase 3: bad decode logits {tuple(lk.shape)}")
        worst = max(worst, float((lk - lr).abs().max()))
        agree += int((lk.argmax(-1) == lr.argmax(-1)).sum())
        total += n
        tok = lk.argmax(-1)
        pos += 1
    log(f"[ref] kernel route vs reference route (impl=ref, attn=gather) over "
        f"{n} prefills + {n_steps} decode steps: max |dlogit| {worst:.4f} "
        f"(tol {LOGIT_ATOL}), greedy-token agreement {agree}/{total}")
    if worst > LOGIT_ATOL:
        raise SystemExit("phase 3: kernel route disagrees with the reference "
                         "route beyond tolerance")


# ------------------------------------------------------------------ main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 plain products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_build(torch)
    rows = phase_matmuls(torch, F)
    rows["paged_gqa_decode"] = phase_attention(torch, F)
    launches = phase_serve(torch)
    meta = {
        "nm_spmv": ("src/repro_torch/csrc/nm_spmv.cu",
                    "src/repro/kernels/nm_spmv.py:67"),
        "nm_xwt": ("src/repro_torch/csrc/nm_xwt.cu",
                   "src/repro/kernels/nm_spmm.py:160"),
        "paged_gqa_decode": ("src/repro_torch/csrc/paged_gqa_decode.cu",
                             "src/repro/kernels/flash_attention.py:199"),
    }
    kernels_line = [dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches[name], **rows[name])
                    for name, (src, rep) in meta.items()]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s "
        f"on {card}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
