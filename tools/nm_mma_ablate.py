#!/usr/bin/env python3
"""Where the time of the N:M bodies goes, by ablation.

  python3 tools/nm_mma_ablate.py [--variants orig,nox,now,noout,nomma,nodec]
  python3 tools/nm_mma_ablate.py --body gather \
      [--variants orig,nox,now,nofma,nostage]
  python3 tools/nm_mma_ablate.py --body tf32 \
      [--variants orig,nodense,nocomp,nodec,nosplit,nomma,noout]

For each variant a copy of ``src/repro_torch/csrc`` is patched to leave
one part of a body out, built into
``src/repro_torch/_build/ablate/<body>-<variant>/`` (gitignored), and
timed in its own process.  The tensor-core tile body of ``nm_mma.cuh``
(``--body mma``, the default):

* ``orig``   the body as it is;
* ``nox``    no X tile copies (the ring's X rows keep stale data);
* ``now``    no W copies (values and indices);
* ``noout``  no output or split-workspace stores;
* ``nomma``  each mma.sync replaced by one integer xor into the sum;
* ``nodec``  each 16-column decompress replaced by an xor of its inputs.

The gather nm_spmv body of ``nm_spmv.cu`` (``--body gather``):

* ``nox``     each x read at a fixed column of the lane's (no index, no
  bank conflict);
* ``now``     no weight loads (the ring's fragments are zero);
* ``nofma``   only batch row 0 converted and multiply-accumulated;
* ``nostage`` x not staged (shared memory keeps stale data).

The f32 split-TF32 body of ``nm_tf32.cuh`` (``--body tf32``):

* ``nodense`` no dense-tile copies (the ring keeps stale data);
* ``nocomp``  no copies of the compressed values and indices;
* ``nodec``   no decompress of the next stage (the A tile keeps stale data);
* ``nosplit`` no hi / lo split (both passes take the raw operand);
* ``nomma``   each mma.sync replaced by one integer xor into the sum;
* ``noout``   no output or split-workspace stores.

The ablated kernels compute nothing useful; only their device times mean
anything: per call, from ``torch.profiler``, under the wrapper's own plan:
for the bf16 bodies one llama3.2-1b layer's linears (2:4): the mma body
at B 8 (onehot), S 32 and S 128 (nm_xwt), the gather body at B 8; for the
f32 body nm_spmm and nm_xwt at four CNN GEMMs at batch 32 (2:4,
``TF32_SHAPES``).  What a variant saves against ``orig`` is that part's
share of the critical path.  Needs one NVIDIA card; prints one JSON line
per variant.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"mma": ("orig", "nox", "now", "noout", "nomma", "nodec"),
            "gather": ("orig", "nox", "now", "nofma", "nostage"),
            "tf32": ("orig", "nodense", "nocomp", "nodec", "nosplit",
                     "nomma", "noout")}
SHAPES = ((2048, 2048), (8192, 2048), (2048, 8192))   # wq, wg, wd
# (marker, replacement) pairs; each variant turns one PROBE_* flag on
MMA_PATCHES = (
    ("      if (a.xvec) {  // X:", "      if (PROBE_NOX) {} else if (a.xvec) {  // X:"),
    ("      if (a.vvec) {  // values:",
     "      if (PROBE_NOW) {} else if (a.vvec) {  // values:"),
    ("      a.idx.stage(", "      if (!PROBE_NOW) a.idx.stage("),
    ("          if (part)\n", "          if (PROBE_NOOUT) {} else if (part)\n"),
    ("mma_bf16(acc[mi][j8], af4, b);",
     "if (PROBE_NOMMA) acc[mi][j8][0] += __int_as_float(af4[0] ^ af4[1] ^ "
     "af4[2] ^ af4[3] ^ b[0] ^ b[1]); else mma_bf16(acc[mi][j8], af4, b);"),
    ("decompress16<N, M>(vw, id, af[mi][h]);",
     "if (PROBE_NODEC) { for (int q = 0; q < 8; ++q) af[mi][h][q] = "
     "vw[q % (P / 2)] ^ id[q % P]; } else decompress16<N, M>(vw, id, "
     "af[mi][h]);"),
)
GATHER_PATCHES = (
    ("XCol<T, BG>::load(xs, base + (SWZ ? off ^ key : off), xv);",
     "XCol<T, BG>::load(xs, base + (PROBE_NOX ? key : SWZ ? off ^ key : off), "
     "xv);"),
    ("  if (wvec) {  // the row's slot count",
     "  if (PROBE_NOW) { f = WFrag<T>{}; return; }\n"
     "  if (wvec) {  // the row's slot count"),
    ("        for (int b = 0; b < BG; ++b) acc[b] = fmaf(w, xv[b], acc[b]);\n"
     "      }\n    }\n  } else {",
     "        for (int b = 0; b < BG; ++b) if (!PROBE_NOFMA || b == 0) "
     "acc[b] = fmaf(w, xv[b], acc[b]);\n      }\n    }\n  } else {"),
    ("  stage_x<T, BG>(xs,", "  if (!PROBE_NOSTAGE) stage_x<T, BG>(xs,"),
)
TF32_PATCHES = (
    ("      unsigned char* dt = base + ly.boff;\n",
     "      unsigned char* dt = base + ly.boff;\n      if (!PROBE_NODENSE)\n"),
    ("      if (a.vvec)  // E % 4 == 0",
     "      if (PROBE_NOCOMP) {} else if (a.vvec)  // E % 4 == 0"),
    ("      a.idx.stage(ich,", "      if (!PROBE_NOCOMP) a.idx.stage(ich,"),
    ("      if (ks == 1 && st + 1 < nst) decompress(",
     "      if (ks == 1 && st + 1 < nst && !PROBE_NODEC) decompress("),
    ("  hi = __float_as_uint(x) & 0xffffe000u;",
     "  if (PROBE_NOSPLIT) { hi = lo = __float_as_uint(x); return; }\n"
     "  hi = __float_as_uint(x) & 0xffffe000u;"),
    ('  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "',
     "  if (PROBE_NOMMA) { d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] "
     "^ b[0] ^ b[1]); return; }\n"
     '  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "'),
    ("  float* out = pl.splits > 1 ?",
     "  if (PROBE_NOOUT) {  // keep every sum live, store nothing\n"
     "    float sink = 0.f;\n"
     "    for (int mi = 0; mi < MT; ++mi) for (int nj = 0; nj < NT; ++nj)\n"
     "      for (int q = 0; q < 4; ++q) sink += acc[mi][nj][q];\n"
     "    if (sink == -1.25e-30f) a.y[0] = sink;\n"
     "    return;\n  }\n"
     "  float* out = pl.splits > 1 ?"),
)
BODIES = {"mma": ("nm_mma.cuh", "#pragma once\n", MMA_PATCHES),
          "gather": ("nm_spmv.cu", '#include "nm_mma.cuh"\n', GATHER_PATCHES),
          "tf32": ("nm_tf32.cuh", "#pragma once\n", TF32_PATCHES)}
# (R, C, K) of the f32 body's GEMMs at batch 32 (2:4): densenet121 L23,
# resnet50 conv5_3x3, densenet121 L1 (K 148), inceptionv3 stem_3x3
TF32_SHAPES = ((128, 25088, 1152), (512, 1568, 4608), (64, 401408, 148),
               (32, 691488, 288))


def patched_source(body: str, variant: str, csrc: str, dst: str) -> None:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    name, anchor, patches = BODIES[body]
    path = os.path.join(dst, name)
    with open(path) as f:
        s = f.read()
    flags = "".join(f"#define PROBE_{v.upper()} {int(v == variant)}\n"
                    for v in VARIANTS[body][1:])
    s = s.replace(anchor, anchor + flags, 1)
    for old, new in patches:
        if old not in s:
            raise SystemExit(f"nm_mma_ablate: marker not found: {old!r}")
        s = s.replace(old, new)
    with open(path, "w") as f:
        f.write(s)


def run_variant(body: str, variant: str) -> dict:
    from pathlib import Path

    sys.path.insert(0, ROOT)               # chip_smoke adds ROOT/src
    import torch

    from chip_smoke import device_ms
    from repro_torch.core.sparsity import compress
    from repro_torch.kernels import build, nm_spmm, nm_spmv
    dst = build.BUILD_DIR / "ablate" / f"{body}-{variant}"
    patched_source(body, variant, str(build.CSRC_DIR), str(dst / "csrc"))
    build.CSRC_DIR, build.BUILD_DIR = Path(dst / "csrc"), Path(dst / "lib")
    build.build_all({"gather": ("nm_spmv",), "tf32": ("nm_xwt",)}.get(
        body, ("nm_spmv", "nm_xwt")))
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    if body == "tf32":
        for r, c, k in TF32_SHAPES:
            w = torch.randn(r, k, generator=gen, device="cuda") * k ** -0.5
            sp = compress(w, 2, 4)
            b = torch.randn(k, c, generator=gen, device="cuda")
            out[f"spmm_{r}x{c}x{k}"] = round(1e3 * device_ms(
                torch, lambda: nm_spmm.nm_spmm(sp.values, sp.indices, b, 2,
                                               4), 5), 2)
            x = b.t().contiguous()
            del b
            out[f"xwt_{r}x{c}x{k}"] = round(1e3 * device_ms(
                torch, lambda: nm_spmm.nm_xwt(x, sp.values, sp.indices, 2,
                                              4), 5), 2)
        return out

    out = {}
    if body == "gather":
        for o, k in ((512, 2048),) + SHAPES:
            w = (torch.randn(o, k, generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            sp = compress(w, 2, 4)
            x = torch.randn(8, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            out[f"rows8_{o}x{k}"] = round(1e3 * device_ms(
                torch, lambda: nm_spmv.nm_spmv(x, sp.values, sp.indices,
                                               2, 4), 20), 2)
        return out
    for rows, decode, kern in ((8, True, nm_spmv.ONEHOT_KERNEL),
                               (32, False, nm_spmm.KERNEL),
                               (128, False, nm_spmm.KERNEL)):
        for o, k in SHAPES:
            w = (torch.randn(o, k, generator=gen, device="cuda")
                 * k ** -0.5).to(torch.bfloat16)
            sp = compress(w, 2, 4)
            x = torch.randn(rows, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            plan = nm_spmm.mma_plan(rows, o, k, 2, 4, decode=decode)
            out[f"rows{rows}_{o}x{k}"] = round(1e3 * device_ms(
                torch, lambda: nm_spmm.launch_planned(
                    kern, x, sp.values, sp.indices, 2, 4, plan), 20), 2)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--body", choices=sorted(BODIES), default="mma")
    ap.add_argument("--variants")
    ap.add_argument("--variant", help=argparse.SUPPRESS)   # one, in-process
    args = ap.parse_args()
    if args.variant:
        print(json.dumps({"body": args.body, "variant": args.variant,
                          "device_us": run_variant(args.body, args.variant)}),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("nm_mma_ablate: needs an NVIDIA card", file=sys.stderr)
        return 1
    rc = 0
    variants = VARIANTS[args.body]
    for v in (args.variants or ",".join(variants)).split(","):
        if v not in variants:
            raise SystemExit(f"unknown variant {v!r} (one of {variants})")
        rc |= subprocess.run([sys.executable, __file__, "--body", args.body,
                              "--variant", v], check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
