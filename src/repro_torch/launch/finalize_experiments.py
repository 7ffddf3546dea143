"""Assemble the final EXPERIMENTS.md tables (counterpart of
``repro.launch.finalize_experiments``).

Merges the baseline grid and every optimized/fixup run (later files win per
cell), recomputes derived fields with exact param counts, writes
results/dryrun_optimized_final.json, and splices the rendered tables into
EXPERIMENTS.md at the <!-- DRYRUN_TABLES --> marker.

  PYTHONPATH=src python -m repro_torch.launch.finalize_experiments
"""

import json
import os

from repro_torch.launch.postprocess import recompute
from repro_torch.launch.report import render, render_sparse, summarize

BASELINE = "results/dryrun_final.json"
OPT_SOURCES = [
    "results/dryrun_optimized.json",
    "results/dryrun_fixup1.json",
    "results/dryrun_fixup2.json",
    "results/dryrun_layout.json",
    "results/dryrun_layout15.json",
    "results/dryrun_layout2.json",
    "results/dryrun_long_fix.json",
]
OPT_OUT = "results/dryrun_optimized_final.json"


def merge(paths):
    cells = {}
    for path in paths:
        if not os.path.exists(path):
            print(f"  (missing {path} — skipped)")
            continue
        for rec in json.load(open(path)):
            key = (rec["arch"], rec["shape"], rec["mesh"])
            # never let a FAIL overwrite an OK from an earlier run
            if rec["status"] == "FAIL" and cells.get(key, {}).get(
                    "status") == "OK":
                continue
            cells[key] = rec
    recs = [recompute(r) for r in cells.values()]
    recs.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    return recs


def main():
    baseline = json.load(open(BASELINE))
    optimized = merge([BASELINE] + OPT_SOURCES)
    with open(OPT_OUT, "w") as f:
        json.dump(optimized, f, indent=1)

    blocks = []
    blocks.append("### Baseline (paper-faithful) — summary\n")
    blocks.append(summarize(baseline))
    blocks.append("\n#### Baseline, single-pod 16x16 (256 chips)\n")
    blocks.append(render(baseline, "16x16"))
    blocks.append("\n#### Baseline, multi-pod 2x16x16 (512 chips)\n")
    blocks.append(render(baseline, "2x16x16"))
    blocks.append("\n### Optimized (post-§Perf) — summary\n")
    blocks.append(summarize(optimized))
    blocks.append("\n#### Optimized, single-pod 16x16\n")
    blocks.append(render(optimized, "16x16"))
    blocks.append("\n#### Optimized, multi-pod 2x16x16\n")
    blocks.append(render(optimized, "2x16x16"))
    blocks.append("\n### Compressed weight stream per arch (2:4 bf16 + "
                  "2-bit packed indices)\n")
    blocks.append(render_sparse(optimized))
    tables = "\n".join(blocks)

    md = open("EXPERIMENTS.md").read()
    start, end = "<!-- DRYRUN_TABLES_START -->", "<!-- DRYRUN_TABLES_END -->"
    assert start in md and end in md, "markers missing"
    i, j = md.index(start) + len(start), md.index(end)
    md = md[:i] + "\n" + tables + "\n" + md[j:]
    with open("EXPERIMENTS.md", "w") as f:
        f.write(md)
    n_ok = sum(r["status"] == "OK" for r in optimized)
    n_fail = sum(r["status"] == "FAIL" for r in optimized)
    print(f"EXPERIMENTS.md updated; optimized grid {n_ok} OK {n_fail} FAIL")


if __name__ == "__main__":
    main()
