#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build: compile the four Hopper kernels of the serving paths from
   ``src/repro_torch/csrc`` with nvcc (sm_90a, one nvcc per source, in
   parallel); print the card's name and power limit from nvidia-smi.
2. Kernel vs plain: hold each kernel against its plain torch version on the
   card, in float32 and bfloat16, at the shapes the two serving paths give
   it, and time it beside its bound, the plain version and one PyTorch call
   that computes the same function (the yardstick; the port never calls
   it): nm_spmv / nm_xwt at one llama3.2-1b layer's and one
   deepseek-v2-lite MoE layer's linears (plus the dense first layer's and
   the latent up-projections' shapes, checked), paged_gqa_decode at the
   llama serving shape, paged_mla_decode at the deepseek one.
3. Serve llama3.2-1b: full width (16 layers, d 2048, 32/8 heads, d_ff
   8192, vocab 128256, bf16, 2:4 compressed; random weights from a seed)
   through ``ServeEngine(kv="paged", attn="fused", compressed=True)``: 8
   slots, 16 requests of 128 prompt tokens, generation mix 16/32, block
   size 16.  Each kernel of the path must have launched during the run.
   Then the same prefills and first decode steps run through the kernel
   route and through the reference route (``impl="ref"``,
   ``attn="gather"``) and the logits are compared.
4. Serve deepseek-v2-lite-16b: full width (27 layers = 1 dense + 26 MoE,
   d 2048, 16 heads, MLA kv_lora 512 / rope 64 / v 128, 64 routed experts
   top-6 + 2 shared of hidden 1408, dense d_ff 10944, vocab 102400, bf16,
   2:4 compressed at init; random weights from a seed), the same engine
   and trace.  nm_spmv, nm_xwt and paged_mla_decode must launch, the
   latter once per layer per decode tick.  The reference-route check runs
   at full width and reduced depth (1 dense + 3 MoE layers) in float32,
   where no bf16 near-tie can flip a router between the routes, and also
   reports how many router top-k sets agree.
5. Summary: a ``{"kernels": [...]}`` line, then the device line last.
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
# one llama3.2-1b decode layer's seven linears (out, in): wq, wk, wv, wo,
# wg, wu, wd
LAYER_SHAPES = [(2048, 2048), (512, 2048), (512, 2048), (2048, 2048),
                (8192, 2048), (8192, 2048), (2048, 8192)]
CHECK_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
# one deepseek-v2-lite MoE layer's linears that the kernels run: wq, wdkv,
# wo and the shared experts' wg, wu, wd in decode (wuk / wuv are read as a
# dense view there), plus wuk and wuv (K = kv_lora 512) in prefill
DS_DECODE_SHAPES = [(3072, 2048), (576, 2048), (2048, 2048),
                    (2816, 2048), (2816, 2048), (2048, 2816)]
DS_PREFILL_SHAPES = DS_DECODE_SHAPES + [(2048, 512), (2048, 512)]
DS_CHECK_SHAPES = [(3072, 2048), (576, 2048), (2048, 512), (2048, 2048),
                   (2816, 2048), (2048, 2816), (10944, 2048), (2048, 10944)]
N, M = 2, 4
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
ATTN_TOL = 2e-4
# Reference-route check (phase 3): logits are O(1) (unit-RMS final state
# against a table with d^-0.5 rows).  The two routes round every linear's
# output to bf16 at different points and 16 layers compound it, so logits
# may move by a few bf16 steps of the residual; 0.25 bounds that with room
# while still failing on any wrong kernel (those move logits by O(1)).
LOGIT_ATOL = 0.25
# Reference-route check (phase 4), float32 over 4 layers: the routes differ
# only by f32 summation order (~1e-7 relative per sum over K <= 10944), so
# logits agree to ~1e-5; 1e-3 leaves room and still fails on any wrong
# kernel or a flipped router top-k set (those move logits by O(0.1)).
LOGIT_ATOL_F32 = 1e-3
LLAMA_PATH = ("nm_spmv", "nm_xwt", "paged_gqa_decode")
DEEPSEEK_PATH = ("nm_spmv", "nm_xwt", "paged_mla_decode")


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


def gib(nbytes: float) -> str:
    return f"{nbytes / 2 ** 30:.2f} GiB"


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


def phase_matmuls(torch, F, model: str, check_shapes, spmv_layer,
                  xwt_layer, seed: int):
    """nm_spmv (decode) and nm_xwt (prefill) against their plain versions
    at ``check_shapes``; timings over one layer's linears in bf16
    (``spmv_layer`` at B 8, ``xwt_layer`` at S 128).  A layer's compressed
    weights are tens of MB, near or above the 50 MB L2."""
    from repro_torch.core.sparsity import decompress
    from repro_torch.kernels import nm_spmm, nm_spmv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {"nm_spmv": 0.0, "nm_xwt": 0.0}
    ok = True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        rtol, atol = TOL[dname]
        for o, k in check_shapes:
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
        raise SystemExit(f"phase 2: a matmul kernel disagrees with its plain "
                         f"version at {model} shapes")

    rows = {}
    for name, fn, plain, b, shapes in (
            ("nm_spmv", nm_spmv.nm_spmv, nm_spmv.nm_spmv_plain, 8,
             spmv_layer),
            ("nm_xwt", nm_spmm.nm_xwt, nm_spmm.nm_xwt_plain, 128,
             xwt_layer)):
        layer = [_compressed(torch, o, k, torch.bfloat16, gen)
                 for o, k in shapes]
        dense = [decompress(sp) for sp in layer]
        xs = {k: torch.randn(b, k, generator=gen, device="cuda").to(
            torch.bfloat16) for k in {k for _, k in shapes}}

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
        log(f"[time] {name} one {model} layer ({len(shapes)} linears, bf16, "
            f"{'B' if name == 'nm_spmv' else 'S'}={b}): kernel {ms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP), plain {plain_ms:.4f} ms, "
            f"F.linear on the decompressed weight {lib_ms:.4f} ms")
        del layer, dense
    return rows


def _paged_table(torch, gen, lens, bs):
    """A shuffled table: slot r owns ceil(lens[r] / bs) distinct blocks
    >= 1; the rest of its row names trash block 0."""
    b = len(lens)
    tw = -(-max(lens) // bs)
    nb = b * tw + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tbl = torch.zeros(b, tw, dtype=torch.int32, device="cuda")
    for r, n in enumerate(lens):
        own = -(-n // bs)
        tbl[r, :own] = perm[r * tw:r * tw + own]
    return tbl, nb


def _paged_inputs(torch, dtype, gen, lens, kvh=8, g=4, d=64, bs=16):
    b = len(lens)
    tbl, nb = _paged_table(torch, gen, lens, bs)
    kp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    kp[0] = 1e4                 # hot trash block: the mask must zero it
    vp[0] = 1e4
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tbl, kv_len


SERVE_LENS = [1, 16, 17, 64, 100, 128, 145, 160]   # ragged kv_len, 8 slots


def phase_attention(torch, F):
    """paged_gqa_decode at the llama serving shape: 8 slots, KVH 8, G 4,
    d 64, block 16, ragged kv_len, shuffled table."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    lens = SERVE_LENS
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


def _mla_inputs(torch, dtype, gen, lens, h=16, r=512, rd=64, bs=16):
    tbl, nb = _paged_table(torch, gen, lens, bs)
    cp = torch.randn(nb, bs, r, generator=gen, device="cuda").to(dtype)
    pp = torch.randn(nb, bs, rd, generator=gen, device="cuda").to(dtype)
    cp[0] = 1e4                 # hot trash block: the mask must zero it
    pp[0] = 1e4
    ql = torch.randn(len(lens), h, r, generator=gen, device="cuda")
    qp = torch.randn(len(lens), h, rd, generator=gen, device="cuda")
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return ql, qp, cp, pp, tbl, kv_len


def phase_mla_attention(torch, F):
    """paged_mla_decode at the deepseek serving shape: 8 slots, 16 heads,
    kv_lora 512, rope 64, block 16, ragged kv_len, shuffled table, f32
    queries against f32 or bf16 pools."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)
    lens = SERVE_LENS
    scale = (128 + 64) ** -0.5          # (qk_nope + qk_rope) ** -0.5
    worst, ok = 0.0, True
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        args = _mla_inputs(torch, dtype, gen, lens)
        e, good = max_err(torch, fa.paged_mla_decode(*args, scale=scale),
                          fa.paged_mla_decode_plain(*args, scale=scale),
                          ATTN_TOL, ATTN_TOL)
        worst, ok = max(worst, e), ok and good
        log(f"[check] paged_mla_decode {dname} pools max_abs_err {e:.3e} "
            f"tol {ATTN_TOL}+{ATTN_TOL}|ref| {'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2: paged_mla_decode disagrees with its plain "
                         "version")
    ql, qp, cp, pp, tbl, kv_len = _mla_inputs(torch, torch.bfloat16, gen, lens)
    b, h, r = ql.shape
    rd = qp.shape[-1]
    length = tbl.shape[1] * cp.shape[1]
    ms = time_ms(torch, lambda: fa.paged_mla_decode(
        ql, qp, cp, pp, tbl, kv_len, scale=scale), iters=50)
    plain_ms = time_ms(torch, lambda: fa.paged_mla_decode_plain(
        ql, qp, cp, pp, tbl, kv_len, scale=scale), iters=20)
    # yardstick: SDPA on the latent gathered into position order (outside
    # the timed call), q = [q_lat | q_pe], k = [ckv | kpe], v = ckv, one kv
    # head shared by the 16 query heads
    ck = cp[tbl.long()].reshape(b, 1, length, r)
    kk = torch.cat([ck, pp[tbl.long()].reshape(b, 1, length, rd)], -1)
    kk = kk.expand(b, h, length, r + rd)
    vv = ck.expand(b, h, length, r)
    qq = torch.cat([ql, qp], -1).to(torch.bfloat16).reshape(b, h, 1, r + rd)
    mask = (torch.arange(length, device="cuda")[None, :]
            < kv_len[:, None].long())[:, None, None, :]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, scale=scale), iters=50)
    pos = sum(lens)
    nbytes = (ql.numel() * 4 + qp.numel() * 4 + pos * (r + rd) * 2
              + tbl.numel() * 4 + b * 4 + b * h * r * 4)
    flops = 2.0 * pos * h * (r + rd + r)
    bnd, by = bound_ms(nbytes, flops, "float32")
    log(f"[time] paged_mla_decode one launch (bf16 pools, 8 slots, 16 heads, "
        f"kv_len {lens}): kernel {ms:.4f} ms, bound {bnd:.5f} ms ({by}, "
        f"{nbytes / 1e6:.2f} MB), plain {plain_ms:.4f} ms, SDPA on the "
        f"gathered latent {lib_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms, max_abs_err=worst)


# ------------------------------------------------------------ phases 3 and 4

def serve_run(torch, model, cfg, path, kw, phase: str):
    """The measured engine run: 16 requests of 128 prompt tokens, gen mix
    16/32, with every launch count zeroed just before and read just after.
    Returns (engine, requests, launches, wall seconds)."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine, synthetic_trace
    # warm-up (first-call library set-up), not counted
    ServeEngine(model, cfg, **kw).run(synthetic_trace(
        cfg, n_requests=2, prompt_len=128, gen_lens=[2], seed=99))
    reqs = synthetic_trace(cfg, n_requests=16, prompt_len=128,
                           gen_lens=[16, 32], seed=0)
    eng = ServeEngine(model, cfg, **kw)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.all_kernels()}
    st = eng.stats()
    log(f"[serve] {cfg.name}: {int(st['tokens'])} tokens in {wall:.3f}s = "
        f"{st['tokens'] / wall:.1f} tokens/s; {int(st['decode_steps'])} decode "
        f"steps, {int(st['prefill_calls'])} prefills, occupancy "
        f"{st['occupancy']:.3f}, weight stream {st['weight_stream_ratio']:.4f}x"
        f" dense ({st['weight_stream_bytes'] / 1e9:.3f} GB/step), "
        f"{int(st['preemptions'])} preemptions")
    log(f"[serve] kernel launches in the run: {launches}")
    if min(launches[name] for name in path) <= 0:
        raise SystemExit(f"{phase}: a kernel of the path never launched: "
                         f"{launches}")
    want = sum(r.max_new_tokens for r in reqs)
    lens_ok = all(len(results[r.rid].tokens) == r.max_new_tokens
                  and not results[r.rid].rejected for r in reqs)
    if st["tokens"] != want or not lens_ok:
        raise SystemExit(f"{phase}: expected {want} tokens over "
                         f"{len(reqs)} requests, got {st['tokens']}")
    return eng, reqs, launches, wall


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] init {cfg.name}: {cfg.n_layers}L d{cfg.d_model} "
        f"{cfg.n_heads}H/{cfg.n_kv}KV d_ff {cfg.d_ff} vocab {cfg.vocab} "
        f"{cfg.dtype} in {time.perf_counter() - t0:.1f}s")
    kw = dict(n_slots=8, max_len=128 + 32, compressed=True,
              kv="paged", attn="fused", block_size=16, device="cuda")
    eng, reqs, launches, _ = serve_run(torch, model, cfg, LLAMA_PATH, kw,
                                       "phase 3")
    check_reference_route(torch, eng.model, eng.cfg, reqs[:8], LOGIT_ATOL,
                          "phase 3")
    profile_breakdown(torch, model, cfg, kw)
    return launches


def phase_serve_deepseek(torch):
    """Full-width deepseek-v2-lite-16b, compressed as it is drawn (the
    dense bf16 model, ~31 GB, never exists at once)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models.config import param_count
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="compressed"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] init {cfg.name}: {cfg.n_layers}L ({cfg.first_dense_layers} "
        f"dense) d{cfg.d_model} {cfg.n_heads}H MLA kv_lora {cfg.kv_lora} "
        f"rope {cfg.qk_rope_dim} v {cfg.v_head_dim}, {cfg.n_experts} experts "
        f"top-{cfg.top_k} + {cfg.n_shared_experts} shared (hidden "
        f"{cfg.moe_dff}), dense d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, {param_count(cfg) / 1e9:.2f} B params "
        f"({param_count(cfg, active_only=True) / 1e9:.2f} B active) in "
        f"{time.perf_counter() - t0:.1f}s; resident "
        f"{gib(torch.cuda.memory_allocated())}, peak "
        f"{gib(torch.cuda.max_memory_allocated())}")
    kw = dict(n_slots=8, max_len=128 + 32, compressed=True,
              kv="paged", attn="fused", block_size=16, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, launches, wall = serve_run(torch, model, cfg, DEEPSEEK_PATH,
                                          kw, "phase 4")
    log(f"[serve] {cfg.name} peak device memory in the run "
        f"{gib(torch.cuda.max_memory_allocated())}")
    want = eng.decode_steps * cfg.n_layers
    if launches["paged_mla_decode"] != want:
        raise SystemExit(f"phase 4: paged_mla_decode launched "
                         f"{launches['paged_mla_decode']} times, expected "
                         f"{eng.decode_steps} ticks x {cfg.n_layers} layers")
    decompress_share(torch, model, cfg, eng, wall)
    profile_breakdown(torch, model, cfg, kw, time_calls=True)
    del eng, model
    torch.cuda.empty_cache()
    check_deepseek_reference_route(torch)
    return launches


def decompress_share(torch, model, cfg, eng, wall):
    """What the faithful MoE costs: every decode tick and every prefill
    decompresses all E experts of all three stacks of every MoE layer to a
    dense view before the batched products."""
    from repro_torch.models import ffn
    moe = model.layers[0].moe
    sp = cfg.sparsity

    def views():
        return [ffn._stacked_dense_view(s, sp) for s in (moe.wg, moe.wu,
                                                          moe.wd)]
    ms = time_ms(torch, views, iters=5, warmup=1)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    dense_bytes = sum(s.w_vals.numel() * s.w_vals.element_size() * sp.m
                      // sp.n for s in (moe.wg, moe.wu, moe.wd))
    calls = eng.decode_steps + eng.prefill_calls
    total = ms * n_moe * calls / 1e3
    log(f"[moe] decompressing one MoE layer's experts (3 stacks, "
        f"{gib(dense_bytes)} of bf16 written) takes {ms:.3f} ms; x {n_moe} "
        f"layers = {ms * n_moe:.1f} ms per decode tick or prefill; "
        f"{calls} such calls in the run = {total:.2f} s of its {wall:.2f} s "
        f"wall ({100 * total / wall:.1f}%)")


def _route_log(ffn):
    """Wrap ``ffn.moe_route`` to record every call's expert ids; returns
    (log list, restore function)."""
    seen, orig = [], ffn.moe_route

    def wrapped(router, xt, k):
        out = orig(router, xt, k)
        seen.append(out[2].sort(-1).values.cpu())
        return out
    ffn.moe_route = wrapped
    return seen, lambda: setattr(ffn, "moe_route", orig)


def check_deepseek_reference_route(torch):
    """Full width, reduced depth (1 dense + 3 MoE layers), float32: the
    kernel route against the reference route, router top-k sets compared
    call by call."""
    from repro_torch.configs import get_config
    from repro_torch.models import ffn, init_model
    from repro_torch.serve import synthetic_trace
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = cfg.replace(n_layers=4, dtype="float32", sparsity=dataclasses.replace(
        cfg.sparsity, mode="compressed"))
    model = init_model(cfg, seed=1, device="cuda")
    reqs = synthetic_trace(cfg, n_requests=4, prompt_len=32, gen_lens=[4],
                           seed=7)
    seen, restore = _route_log(ffn)
    try:
        check_reference_route(torch, model, cfg, reqs, LOGIT_ATOL_F32,
                              "phase 4", routing=seen)
    finally:
        restore()


def check_reference_route(torch, model, cfg, reqs, tol, phase,
                          n_steps: int = 4, routing=None):
    """The engine's prefills and first decode steps through the kernel
    route and through the reference route (impl='ref' decompress + f32
    product, attn='gather'), both teacher-forced with the kernel route's
    greedy tokens; logits must agree within ``tol``.  With ``routing`` (the
    list ``_route_log`` fills), the router top-k sets of the two routes are
    compared call by call and their agreement printed."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import BlockPool
    ref_cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                       impl="ref"))
    n = len(reqs)
    plen = reqs[0].prompt_len
    pools = {r: BlockPool(cfg, n, plen + n_steps, 16, device="cuda")
             for r in ("kernel", "ref")}
    routed = {"kernel": [], "ref": []}

    def take_routing(route):
        if routing is not None:
            routed[route].extend(routing)
            routing.clear()

    worst, agree, total = 0.0, 0, 0
    first = []
    for slot, req in enumerate(reqs):
        batch = {"tokens": torch.tensor(req.inputs["tokens"][None],
                                        dtype=torch.long, device="cuda")}
        out = {}
        for route, c in (("kernel", cfg), ("ref", ref_cfg)):
            pool = pools[route]
            pool.alloc(slot, pool.blocks_for(plen))
            out[route], pf = prefill(model, c, batch)
            pool.seed(slot, pf, plen)
            take_routing(route)
        worst = max(worst, float((out["kernel"] - out["ref"]).abs().max()))
        agree += int(out["kernel"].argmax() == out["ref"].argmax())
        total += 1
        first.append(int(out["kernel"].argmax()))
        if not bool(torch.isfinite(out["kernel"]).all()):
            raise SystemExit(f"{phase}: non-finite prefill logits")
    tok = torch.tensor(first, dtype=torch.long, device="cuda")
    pos = torch.full((n,), plen, dtype=torch.int32, device="cuda")
    for _ in range(n_steps):
        logits = {}
        for route, c, attn in (("kernel", cfg, "fused"),
                               ("ref", ref_cfg, "gather")):
            pool = pools[route]
            for slot in range(n):
                pool.ensure(slot, int(pos[slot]))
            logits[route], _ = decode_step(model, c, pool.caches, tok, pos,
                                           pool.device_table(),
                                           attn_impl=attn)
            take_routing(route)
        lk, lr = logits["kernel"], logits["ref"]
        if (tuple(lk.shape) != (n, cfg.vocab)
                or not bool(torch.isfinite(lk).all())):
            raise SystemExit(f"{phase}: bad decode logits {tuple(lk.shape)}")
        worst = max(worst, float((lk - lr).abs().max()))
        agree += int((lk.argmax(-1) == lr.argmax(-1)).sum())
        total += n
        tok = lk.argmax(-1)
        pos += 1
    extra = ""
    if routing is not None:
        sets = sum(a.shape[0] for a in routed["kernel"])
        same = sum(int((a == b).all(-1).sum())
                   for a, b in zip(routed["kernel"], routed["ref"]))
        extra = (f", router top-{cfg.top_k} sets agreeing {same}/{sets} "
                 f"({100 * same / max(sets, 1):.2f}%) over "
                 f"{len(routed['kernel'])} MoE calls")
    log(f"[ref] {cfg.name} ({cfg.n_layers}L, {cfg.dtype}) kernel route vs "
        f"reference route (impl=ref, attn=gather) over {n} prefills + "
        f"{n_steps} decode steps: max |dlogit| {worst:.3e} (tol {tol}), "
        f"greedy-token agreement {agree}/{total}{extra}")
    if worst > tol:
        raise SystemExit(f"{phase}: kernel route disagrees with the reference "
                         f"route beyond tolerance")


def profile_breakdown(torch, model, cfg, kw, time_calls: bool = False):
    """Where the time goes: device time by kernel over a traced engine run
    (8 requests, 128 prompt tokens, 16 generated), against its wall time.
    The trace itself slows the host, so the wall here is not the rate.
    With ``time_calls`` a second, untraced run of the same trace times each
    decode tick and each prefill on the host clock (synchronised)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeEngine, engine, synthetic_trace
    reqs = synthetic_trace(cfg, n_requests=8, prompt_len=128, gen_lens=[16],
                           seed=5)
    eng = ServeEngine(model, cfg, **kw)
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
        low = name.lower()
        label = next((k for k in ("nm_spmv", "nm_xwt", "paged_gqa_decode",
                                  "paged_mla_decode") if k in name), None)
        if label is None:   # cuBLAS on Hopper names its gemms nvjet_*
            if any(s in low for s in ("gemm", "cutlass", "nvjet")):
                label = "cuBLAS gemm"
            elif "scatter" in low:
                label = "scatter (decompress)"
            else:
                label = "other"
        groups[label] = groups.get(label, 0.0) + us / 1e3
        kernels.append((us / 1e3, ev.count, name[:60]))
    busy = sum(groups.values())
    if busy <= 0:
        raise SystemExit("profile: the trace recorded no device time")
    parts = ", ".join(f"{k} {v:.2f} ms" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"[profile] {cfg.name} traced run ({eng.stats()['decode_steps']:.0f} "
        f"decode steps, {eng.prefill_calls} prefills): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%): {parts}")
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        log(f"[profile]   {ms:9.2f} ms  {count:6d}x  {name}")
    if not time_calls:
        return
    spent = {"decode_step": [], "prefill": []}
    orig = {name: getattr(engine, name) for name in spent}

    def timed(name):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[name](*a, **k)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t)
            return out
        return call
    try:
        for name in spent:
            setattr(engine, name, timed(name))
        ServeEngine(model, cfg, **kw).run(reqs)
    finally:
        for name, fn in orig.items():
            setattr(engine, name, fn)
    for name, ts in spent.items():
        log(f"[profile] {cfg.name} {name}: {len(ts)} calls, mean "
            f"{1e3 * sum(ts) / len(ts):.2f} ms, min {1e3 * min(ts):.2f} ms "
            f"(host clock, synchronised)")


# ------------------------------------------------------------------ main

KERNEL_META = {
    "nm_spmv": ("src/repro_torch/csrc/nm_spmv.cu",
                "src/repro/kernels/nm_spmv.py:67"),
    "nm_xwt": ("src/repro_torch/csrc/nm_xwt.cu",
               "src/repro/kernels/nm_spmm.py:160"),
    "paged_gqa_decode": ("src/repro_torch/csrc/paged_gqa_decode.cu",
                         "src/repro/kernels/flash_attention.py:199"),
    "paged_mla_decode": ("src/repro_torch/csrc/paged_mla_decode.cu",
                         "src/repro/kernels/flash_attention.py:291"),
}


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
    rows = phase_matmuls(torch, F, "llama3.2-1b", CHECK_SHAPES, LAYER_SHAPES,
                         LAYER_SHAPES, seed=0)
    ds_rows = phase_matmuls(torch, F, "deepseek-v2-lite MoE", DS_CHECK_SHAPES,
                            DS_DECODE_SHAPES, DS_PREFILL_SHAPES, seed=3)
    for name, row in ds_rows.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        row["max_abs_err"])
        rows[name]["at_deepseek_layer"] = {
            k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}
    rows["paged_gqa_decode"] = phase_attention(torch, F)
    rows["paged_mla_decode"] = phase_mla_attention(torch, F)
    by_path = {"llama3.2-1b": phase_serve(torch),
               "deepseek-v2-lite-16b": phase_serve_deepseek(torch)}
    kernels_line = []
    for name, (src, rep) in KERNEL_META.items():
        per_path = {p: counts[name] for p, counts in by_path.items()
                    if counts[name]}
        kernels_line.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=sum(per_path.values()), launches_by_path=per_path,
            **rows[name]))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s "
        f"on {card}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
