#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port on one NVIDIA card.

  python3 tools/port_ab.py ROOT [--rates] [--spec-twice] [--kernels]
                                [--device-table] [--coldstart]

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
  trace, configuration and timed run; graphed and prewarmed where the
  checkout's ``chip_smoke.py`` has ``graphed``), and of the models of
  chip_smoke's phases 10-12 on their paged fused engine runs (gemma2-9b,
  falcon-mamba-7b and zamba2-7b at the depths those phases serve,
  whisper-small and qwen2-vl-7b with their qkv biases drawn, qwen2-vl-7b
  on its embeddings trace); and ``tokens_sha1``: a digest of each run's
  tokens in request order, so two checkouts' tokens compare.
* with ``--spec-twice``: full-width deepseek-v2-lite-16b served twice
  through the speculative engine (chip_smoke's phase-6 trace and
  configuration): ``requests_identical`` of 16 between the two runs and
  each run's counters.
* with ``--kernels`` (and then instead of the above): one llama3.2-1b
  layer's seven linears (2:4, bf16, chip_smoke's ``LAYER_SHAPES``)
  through the checkout's own wrappers: the onehot nm_spmv body at B 8,
  nm_xwt at S 128 and S 32, packed nm_xwt at S 128, and ``F.linear`` on
  the decompressed weights at each of those row counts.  Per case ``ms`` (CUDA events around 20 calls of the layer, so
  the wrappers' host time is in it), ``device_ms`` (the device time of
  every kernel the layer launched, from ``torch.profiler``, per layer) and
  ``bound_ms`` (the layer's bytes, each input read once and the output
  written once, over 3.35 TB/s).
* with ``--device-table`` (and then instead of the above): the device
  time (``device_ms``: every kernel the call launched, from
  ``torch.profiler``) of each kernel of the port beside the one PyTorch
  call that computes the same function, with the bound, at the shapes of
  the checkout's ``chip_smoke.py``: the gather nm_spmv body over one
  llama3.2-1b layer at B 8 (2:4 and the rerank draft's 1:4) against
  ``F.linear``; paged_gqa_decode / paged_gqa_verify and paged_mla_decode
  / paged_mla_verify at the serving shape (8 slots, ``SERVE_LENS``, span
  4, bf16 pools) against SDPA on the gathered cache; flash_attention at
  the phase-2 cases against SDPA (none with a softcap); over the 15 CNN
  layers (2:4, TF32 off), f32 nm_spmm against ``torch.mm(W, cols^T)`` and
  f32 nm_xwt against ``torch.mm(cols, W^T)`` at batch 32 and 1, and bf16
  nm_spmm at batch 32 against bf16 ``torch.mm``, all on the dense
  weights.  Per case ``device_ms``, ``library_device_ms``, ``factor``
  (their ratio) and ``bound_ms`` (an f32 N:M product's operations at the
  lesser of its N/M MACs on the CUDA cores and three TF32 passes over
  its dense MACs).
* with ``--coldstart`` (and then instead of the above; a checkout whose
  CLI has ``--compile-cache``): cold against warm bring-up.  The serve CLI
  (``repro_torch.launch.serve``, full-width llama3.2-1b, ``--prewarm``, 8
  slots, 8 requests of 128 prompt tokens, 16 generated) runs twice in a
  child process over one fresh ``--compile-cache`` directory: the first
  builds every kernel with nvcc, the second loads the libraries.  Per run
  the child's wall seconds (interpreter start to exit) and its compile
  line (bring-up, prewarm captures, first and steady tick).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time


HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke(root: str, name: str = "chip_smoke"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)      # puts ROOT/src first on sys.path
    return mod


def _own_smoke():
    """This tool's own checkout's ``chip_smoke.py`` (a parent checkout's
    may predate what the tool uses of it: ``device_ms``, the one profiler
    helper, and ``nm_f32_bound_ms``), loaded without leaving that
    checkout's ``src`` on sys.path, so both checkouts are timed and
    bounded alike."""
    saved = list(sys.path)
    try:
        return _load_smoke(HERE, "chip_smoke_own")
    finally:
        sys.path[:] = saved


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


def attention_device_ms(device_ms, torch, fn, calls: int = 50) -> float:
    """Device time per launch of the port's paged attention kernel in
    ``fn`` (one launch per call), from ``torch.profiler`` over ``calls``
    calls."""
    ms, seen = device_ms(torch, fn, calls, match="paged_", names=True)
    if sum(seen.values()) != calls:
        raise SystemExit(f"port_ab: traced {sum(seen.values())} attention "
                         f"launches, expected {calls}")
    return ms


def _layer(torch, smoke, seed: int = 11):
    """One llama3.2-1b layer at 2:4 in bf16: compressed weights, packed
    words, the dense weights and x at 8, 32 and 128 rows."""
    from repro_torch.core.sparsity import decompress
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(seed)
    layer = [smoke._compressed(torch, o, k, torch.bfloat16, gen)
             for o, k in smoke.LAYER_SHAPES]
    words = [ops.pack_block_indices(sp.indices, 2, 4, (128, 128, 512))
             for sp in layer]
    dense = [decompress(sp) for sp in layer]
    xs = {r: {k: torch.randn(r, k, generator=gen, device="cuda").to(
        torch.bfloat16) for k in {k for _, k in smoke.LAYER_SHAPES}}
        for r in (8, 32, 128)}
    return layer, words, dense, xs


def kernel_times(torch, F, smoke, device_ms) -> dict:
    from repro_torch.kernels import nm_spmm, nm_spmv
    layer, words, dense, xs = _layer(torch, smoke)
    cases = {
        "nm_spmv_onehot_b8": (8, lambda x, sp, w: nm_spmv.nm_spmv(
            x, sp.values, sp.indices, 2, 4, mode="onehot")),
        "nm_xwt_s128": (128, lambda x, sp, w: nm_spmm.nm_xwt(
            x, sp.values, sp.indices, 2, 4)),
        "nm_xwt_s32": (32, lambda x, sp, w: nm_spmm.nm_xwt(
            x, sp.values, sp.indices, 2, 4)),
        "nm_xwt_packed_s128": (128, lambda x, sp, w: nm_spmm.nm_xwt_packed(
            x, sp.values, w, 2, 4)),
    }
    out = {}
    for name, (rows, f) in cases.items():
        def run(f=f, rows=rows):
            return [f(xs[rows][sp.dense_shape[1]], sp, w)
                    for sp, w in zip(layer, words)]
        idx_bytes = sum((w if "packed" in name else sp.indices).numel()
                        * (4 if "packed" in name else 1)
                        for sp, w in zip(layer, words))
        nbytes = idx_bytes + sum(rows * (o + k) * 2 + sp.values.numel() * 2
                                 for sp, (o, k) in zip(layer,
                                                       smoke.LAYER_SHAPES))
        dev, seen = device_ms(torch, run, 20, names=True)
        out[name] = dict(ms=smoke.time_ms(torch, run), device_ms=dev,
                         bound_ms=nbytes / smoke.HBM_BYTES_PER_S * 1e3,
                         kernels=sorted(k[:48] for k in seen))
    for rows in (8, 32, 128):
        def lin(rows=rows):
            return [F.linear(xs[rows][w.shape[1]], w) for w in dense]
        dev, seen = device_ms(torch, lin, 20, names=True)
        out[f"F.linear_rows{rows}"] = dict(ms=smoke.time_ms(torch, lin),
                                           device_ms=dev,
                                           kernels=sorted(k[:48] for k in seen))
    return out


def decode_device_ms(torch, smoke, device_ms) -> dict:
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(6)
    g = smoke._paged_inputs(torch, torch.bfloat16, gen, smoke.SERVE_LENS)
    m = smoke._mla_inputs(torch, torch.bfloat16, gen, smoke.SERVE_LENS)
    scale = (128 + 64) ** -0.5
    return dict(
        paged_gqa_decode_device_ms=attention_device_ms(
            device_ms, torch, lambda: fa.paged_gqa_decode(*g, scale=0.125)),
        paged_mla_decode_device_ms=attention_device_ms(
            device_ms, torch, lambda: fa.paged_mla_decode(*m, scale=scale)))


def _pair(device_ms, torch, kernel_fn, lib_fn, bound, calls=20) -> dict:
    dev = device_ms(torch, kernel_fn, calls)
    lib = device_ms(torch, lib_fn, calls) if lib_fn is not None else None
    return dict(device_ms=dev, library_device_ms=lib,
                factor=None if lib is None else dev / lib, bound_ms=bound)


def _gather_rows(torch, F, smoke, device_ms) -> dict:
    """The gather nm_spmv body over one llama layer's seven linears at B 8,
    2:4 and 1:4 (bf16), against F.linear on the decompressed weights."""
    from repro_torch.core.sparsity import decompress
    from repro_torch.kernels import nm_spmv
    out = {}
    for n in (2, 1):
        gen = torch.Generator(device="cuda").manual_seed(12 + n)
        layer = [smoke._compressed(torch, o, k, torch.bfloat16, gen, n)
                 for o, k in smoke.LAYER_SHAPES]
        dense = [decompress(sp) for sp in layer]
        xs = {k: torch.randn(8, k, generator=gen, device="cuda").to(
            torch.bfloat16) for _, k in smoke.LAYER_SHAPES}
        nbytes = sum(8 * (o + k) * 2 + sp.values.numel() * 3
                     for sp, (o, k) in zip(layer, smoke.LAYER_SHAPES))
        out[f"nm_spmv_gather_{n}of4_b8"] = _pair(
            device_ms, torch,
            lambda: [nm_spmv.nm_spmv(xs[sp.dense_shape[1]], sp.values,
                                     sp.indices, n, 4) for sp in layer],
            lambda: [F.linear(xs[w.shape[1]], w) for w in dense],
            nbytes / smoke.HBM_BYTES_PER_S * 1e3)
        del layer, dense
    return out


def _attention_rows(torch, F, smoke, device_ms) -> dict:
    """The paged attention kernels at chip_smoke's serving shapes (bf16
    pools, 8 slots, SERVE_LENS; verify at span SPAN with its table), each
    against SDPA on the cache gathered into position order (outside the
    timed call)."""
    from repro_torch.kernels import flash_attention as fa
    lens, s = smoke.SERVE_LENS, smoke.SPAN
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    bf = torch.bfloat16
    for span in (1, s):
        kvh, g, d, bs = 8, 4, 64, 16
        tbl, nb = (smoke._span_table(torch, gen, lens, span, bs) if span > 1
                   else smoke._paged_table(torch, gen, lens, bs))
        b, length = len(lens), tbl.shape[1] * bs
        kp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(bf)
        vp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(bf)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(b, span, kvh, g, d, generator=gen,
                        device="cuda").to(bf)
        kr = kp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
        vr = vp[tbl.long()].reshape(b, length, kvh, d).repeat_interleave(g, 2)
        kr, vr = kr.transpose(1, 2).contiguous(), vr.transpose(1, 2).contiguous()
        qq = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, span, d)
        mask = smoke._span_mask(torch, kv_len, span, length)
        pos = sum(n + span - 1 for n in lens)
        nbytes = (q.numel() * 2 + pos * kvh * 2 * d * 2 + tbl.numel() * 4
                  + b * 4 + b * span * kvh * g * d * 4)
        if span == 1:
            q1 = q[:, 0].contiguous()
            kern = lambda: fa.paged_gqa_decode(q1, kp, vp, tbl, kv_len,
                                               scale=0.125)
        else:
            kern = lambda: fa.paged_gqa_verify(q, kp, vp, tbl, kv_len,
                                               scale=0.125)
        out["paged_gqa_" + ("decode" if span == 1 else "verify")] = _pair(
            device_ms, torch, kern,
            lambda: F.scaled_dot_product_attention(qq, kr, vr, attn_mask=mask,
                                                   scale=0.125),
            nbytes / smoke.HBM_BYTES_PER_S * 1e3)

        h, r, rd = 16, 512, 64
        scale = (128 + 64) ** -0.5
        cp = torch.randn(nb, bs, r, generator=gen, device="cuda").to(bf)
        pp = torch.randn(nb, bs, rd, generator=gen, device="cuda").to(bf)
        ql = torch.randn(b, span, h, r, generator=gen, device="cuda")
        qp = torch.randn(b, span, h, rd, generator=gen, device="cuda")
        ck = cp[tbl.long()].reshape(b, 1, length, r)
        kk = torch.cat([ck, pp[tbl.long()].reshape(b, 1, length, rd)], -1)
        kk = kk.expand(b, h, length, r + rd)
        vv = ck.expand(b, h, length, r)
        qq2 = torch.cat([ql, qp], -1).to(bf).transpose(1, 2)
        seen = sum(n + i for n in lens for i in range(span))
        nbytes = (ql.numel() * 4 + qp.numel() * 4 + pos * (r + rd) * 2
                  + tbl.numel() * 4 + b * 4 + b * span * h * r * 4)
        bnd, _ = smoke.bound_ms(nbytes, 2.0 * seen * h * (r + rd + r),
                                "float32")
        if span == 1:
            ql1, qp1 = ql[:, 0].contiguous(), qp[:, 0].contiguous()
            kern = lambda: fa.paged_mla_decode(ql1, qp1, cp, pp, tbl, kv_len,
                                               scale=scale)
        else:
            kern = lambda: fa.paged_mla_verify(ql, qp, cp, pp, tbl, kv_len,
                                               scale=scale)
        out["paged_mla_" + ("decode" if span == 1 else "verify")] = _pair(
            device_ms, torch, kern,
            lambda: F.scaled_dot_product_attention(qq2, kk, vv,
                                                   attn_mask=mask,
                                                   scale=scale), bnd)
    return out


def _flash_rows(torch, F, smoke, device_ms) -> dict:
    """flash_attention_kernel at chip_smoke's FLASH_CASES (bf16) against
    SDPA with the same mask (none where the case has a softcap)."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    for label, bh, sq, sk, d, dv, kw in smoke.FLASH_CASES:
        bf = torch.bfloat16
        q = torch.randn(bh, sq, d, generator=gen, device="cuda").to(bf)
        k = torch.randn(bh, sk, d, generator=gen, device="cuda").to(bf)
        v = torch.randn(bh, sk, dv, generator=gen, device="cuda").to(bf)
        q_off = kw.get("q_off", sk - sq)
        lib = None
        if "cap" not in kw:
            qpos = q_off + torch.arange(sq, device="cuda")[:, None]
            kpos = torch.arange(sk, device="cuda")[None, :]
            mask = qpos >= kpos
            if kw.get("window") is not None:
                mask &= qpos - kpos < kw["window"]
            qq, kk, vv = q[:, None], k[:, None], v[:, None]
            lib = lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                         attn_mask=mask)
        pairs = bh * smoke._live_pairs(torch, sq, sk, kw.get("causal", True),
                                       kw.get("window"), q_off)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + bh * sq * dv)
        bnd, _ = smoke.bound_ms(nbytes, 2.0 * pairs * (d + dv), "bfloat16")
        out[f"flash_attention {label}"] = _pair(
            device_ms, torch,
            lambda: fa.flash_attention_kernel(q, k, v, **kw), lib, bnd,
            calls=3 if sq >= 4096 else 20)
    return out


def _spmm_rows(torch, smoke, own) -> dict:
    """The N:M GEMM kernels over the 15 CNN layers (2:4, TF32 off), summed:
    f32 nm_spmm (C = W . cols^T) against torch.mm(W, cols^T) and f32 nm_xwt
    (Y = cols . W^T) against torch.mm(cols, W^T), both at batch 32 and 1,
    and bf16 nm_spmm at batch 32 against bf16 torch.mm, on the dense
    pruned weights.  f32 bounds: ``own.nm_f32_bound_ms``."""
    from repro_torch.core.sparsity import decompress
    from repro_torch.kernels import nm_spmm
    from repro_torch.models.cnn import CNN_LAYER_CONVS, im2col, sparse_conv_init
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(15)
    cases = (("nm_spmm 15 CNN layers", 32, torch.float32, "spmm"),
             ("nm_xwt f32 15 CNN layers", 32, torch.float32, "xwt"),
             ("nm_spmm 15 CNN layers batch 1", 1, torch.float32, "spmm"),
             ("nm_xwt f32 15 CNN layers batch 1", 1, torch.float32, "xwt"),
             ("nm_spmm bf16 15 CNN layers", 32, torch.bfloat16, "spmm"))
    out = {}
    for label, batch, dtype, kind in cases:
        dev = lib = bound = 0.0
        for convs in CNN_LAYER_CONVS.values():
            for _, c_in, c_out, kh, kw, stride, h in convs:
                w = sparse_conv_init(gen, c_in, c_out, kh, kw, 2, 4)
                x = torch.randn(batch, h, h, c_in, generator=gen,
                                device="cuda")
                cols, _ = im2col(x, kh, kw, stride)
                ckp = w.dense_shape[1]
                cols = F.pad(cols, (0, ckp - cols.shape[1])).to(dtype)
                vals = w.values.to(dtype)
                wd = decompress(w).to(dtype)
                if kind == "spmm":
                    colst = cols.t().contiguous()
                    kern = lambda: nm_spmm.nm_spmm(vals, w.indices, colst, 2, 4)
                    ref = lambda: torch.mm(wd, colst)
                else:
                    wt = wd.t()
                    kern = lambda: nm_spmm.nm_xwt(cols, vals, w.indices, 2, 4)
                    ref = lambda: torch.mm(cols, wt)
                dev += own.device_ms(torch, kern, 5)
                lib += own.device_ms(torch, ref, 5)
                es = cols.element_size()
                nbytes = es * (cols.numel() + cols.shape[0] * c_out) \
                    + vals.numel() * (es + 1)
                if dtype == torch.float32:
                    bound += own.nm_f32_bound_ms(nbytes, cols.shape[0], c_out,
                                                 ckp, vals.numel())[0]
                else:
                    bound += smoke.bound_ms(nbytes, 2.0 * cols.shape[0]
                                            * vals.numel(), "bfloat16")[0]
                del x, cols
        out[label] = dict(device_ms=dev, library_device_ms=lib,
                          factor=dev / lib, bound_ms=bound)
    return out


def device_table(torch, F, smoke, own) -> dict:
    device_ms = own.device_ms
    out = {}
    for part in (lambda: _gather_rows(torch, F, smoke, device_ms),
                 lambda: _attention_rows(torch, F, smoke, device_ms),
                 lambda: _flash_rows(torch, F, smoke, device_ms),
                 lambda: _spmm_rows(torch, smoke, own)):
        out.update(part())
        print(f"port_ab: {sorted(out)} done", file=sys.stderr, flush=True)
    return out


def rate_cases(smoke) -> tuple:
    """(arch, layers (None: as published), launch path, whether the qkv
    biases are drawn, the trace (None: phase 3's)) of each model that
    ``rates`` serves; the phases 10-12 models only where the checkout's
    ``chip_smoke.py`` has them."""
    cases = (("llama3.2-1b", None, smoke.LLAMA_PATH, False, None),
             ("deepseek-v2-lite-16b", None, smoke.DEEPSEEK_PATH, False,
              None))
    if hasattr(smoke, "vlm_trace"):
        cases += (
            ("gemma2-9b", smoke.GEMMA_SERVE_LAYERS, smoke.LLAMA_PATH, False,
             None),
            ("falcon-mamba-7b", smoke.SSM_SERVE_LAYERS["falcon-mamba-7b"],
             smoke.SSM_PATH, False, None),
            ("zamba2-7b", smoke.SSM_SERVE_LAYERS["zamba2-7b"],
             smoke.HYBRID_PATH, False, None),
            ("whisper-small", None, smoke.ENCDEC_PATH, True, None),
            ("qwen2-vl-7b", None, smoke.ENCDEC_PATH, True, smoke.vlm_trace))
    return cases


def rates(torch, smoke) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    out, tokens = {}, {}
    for arch, layers, path, biases, trace in rate_cases(smoke):
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        if arch != "llama3.2-1b":       # compressed as drawn
            cfg = cfg.replace(sparsity=dataclasses.replace(
                cfg.sparsity, mode="compressed"))
        model = init_model(cfg, seed=0, device="cuda")
        if biases:
            smoke.draw_biases(torch, model, seed=1)
        kw = dict(n_slots=8, max_len=128 + 32, compressed=True, kv="paged",
                  attn="fused", block_size=16, device="cuda")
        kw = getattr(smoke, "graphed", dict)(kw)
        eng, reqs, _, wall, _ = smoke.serve_run(
            torch, model, cfg, path, kw, arch,
            None if trace is None else trace(cfg))
        out[arch] = eng.stats()["tokens"] / wall
        digest = hashlib.sha1()
        for r in reqs:
            digest.update(eng.results[r.rid].tokens.astype("<i4").tobytes())
        tokens[arch] = digest.hexdigest()
        del eng, model
        torch.cuda.empty_cache()
    return dict(tokens_per_s=out, tokens_sha1=tokens)


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
    kw = getattr(smoke, "graphed", dict)(kw)
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


def coldstart(root: str) -> dict:
    """Cold against warm bring-up of the checkout's serve CLI over one
    fresh kernel build directory (see the module's note)."""
    cache = os.path.join(root, "src", "repro_torch", "_build",
                         f"coldstart-{os.getpid()}")
    shutil.rmtree(cache, ignore_errors=True)
    # the checkout's src on sys.path, not on PYTHONPATH: that would also
    # run its sitecustomize (the JAX package's start-up shims)
    run_cli = ("import sys; sys.path.insert(0, sys.argv.pop(1)); "
               "from repro_torch.launch import serve; serve.main(sys.argv[1:])")
    cmd = [sys.executable, "-c", run_cli, os.path.join(root, "src"), "--arch",
           "llama3.2-1b", "--scheduler", "continuous", "--kv", "paged",
           "--attn", "fused", "--prewarm", "--compile-cache", cache, "--slots",
           "8", "--requests", "8", "--prompt-len", "128", "--gen", "16",
           "--block-size", "16"]
    out = {}
    try:
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=root, capture_output=True,
                               text=True, timeout=900)
            wall = time.perf_counter() - t0
            if r.returncode:
                raise SystemExit(f"coldstart: the {run} run failed:\n"
                                 f"{r.stdout}\n{r.stderr}")
            line = next(ln for ln in r.stdout.splitlines()
                        if ln.startswith("compile["))
            out[run] = dict(process_s=wall, compile_line=line)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--rates", action="store_true")
    ap.add_argument("--spec-twice", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--device-table", action="store_true")
    ap.add_argument("--coldstart", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("port_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 plain products
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.abspath(args.root)
    if args.coldstart:        # child processes only: nothing built here
        print(json.dumps(dict(root=root, coldstart=coldstart(root))),
              flush=True)
        return 0
    own = _own_smoke()
    device_ms = own.device_ms
    smoke = _load_smoke(root)
    smoke.phase_build(torch)
    out = dict(root=root)
    if not (args.kernels or args.device_table):
        out.update(
            paged_gqa_decode_ms=smoke.phase_attention(torch, F)["ms"],
            paged_mla_decode_ms=smoke.phase_mla_attention(torch, F)["ms"],
            **decode_device_ms(torch, smoke, device_ms),
            trash_write=trash_write(torch))
    if args.rates:
        out.update(rates(torch, smoke))
    if args.spec_twice:
        out["serve_twice"] = serve_twice(torch, smoke)
    if args.kernels:
        out["kernels"] = kernel_times(torch, F, smoke, device_ms)
    if args.device_table:
        out["device_table"] = device_table(torch, F, smoke, own)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
