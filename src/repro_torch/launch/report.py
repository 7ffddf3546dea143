"""Render dry-run JSON records into roofline tables (counterpart of
``repro.launch.report``).

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_baseline.json
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.0f}B"


def render(records, mesh_filter=None) -> str:
    lines = []
    lines.append("| arch | shape | mesh | status | compute | memory | "
                 "collective | dominant | 6ND/HLO | roofline frac | "
                 "fit (args+temp) |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in records:
        if mesh_filter and r["mesh"] != mesh_filter:
            continue
        if r["status"] == "SKIP":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP |"
                         f" — | — | — | — | — | — | — |")
            continue
        if r["status"] != "OK":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"FAIL | {r.get('error','')[:60]} ||||||")
            continue
        rr = r["roofline"]
        m = r.get("memory", {})
        fit = (m.get("argument_size_in_bytes", 0)
               + m.get("temp_size_in_bytes", 0))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK "
            f"| {fmt_s(rr['compute_s'])} | {fmt_s(rr['memory_s'])} "
            f"| {fmt_s(rr['collective_s'])} | {rr['dominant']} "
            f"| {rr['useful_flops_ratio']:.3f} "
            f"| {rr['roofline_fraction']:.4f} | {fmt_b(fit)} |")
    return "\n".join(lines)


def render_sparse(records) -> str:
    """Fig-12-style table: compressed vs dense weight-stream bytes."""
    seen = set()
    lines = ["| arch | dense weight bytes | compressed (2:4 + 2-bit idx) | "
             "reduction |", "|---|---|---|---|"]
    for r in records:
        if r["status"] != "OK" or r["arch"] in seen:
            continue
        seen.add(r["arch"])
        sw = r["sparse_weights"]
        lines.append(f"| {r['arch']} | {fmt_b(sw['dense_bytes'])} "
                     f"| {fmt_b(sw['compressed_bytes'])} "
                     f"| {sw['reduction']:.1%} |")
    return "\n".join(lines)


def summarize(records) -> str:
    n_ok = sum(r["status"] == "OK" for r in records)
    n_skip = sum(r["status"] == "SKIP" for r in records)
    n_fail = sum(r["status"] == "FAIL" for r in records)
    doms = defaultdict(int)
    worst = []
    for r in records:
        if r["status"] == "OK":
            doms[r["roofline"]["dominant"]] += 1
            worst.append((r["roofline"]["roofline_fraction"],
                          f"{r['arch']}x{r['shape']}x{r['mesh']}"))
    worst.sort()
    out = [f"OK={n_ok} SKIP={n_skip} FAIL={n_fail}; dominant terms: "
           + ", ".join(f"{k}={v}" for k, v in sorted(doms.items()))]
    out.append("worst roofline fractions: "
               + "; ".join(f"{w[1]} ({w[0]:.4f})" for w in worst[:5]))
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_baseline.json"
    records = json.load(open(path))
    print(summarize(records))
    print()
    print("### single-pod 16x16\n")
    print(render(records, "16x16"))
    print()
    print("### multi-pod 2x16x16\n")
    print(render(records, "2x16x16"))
    print()
    print("### sparse weight stream (per arch)\n")
    print(render_sparse(records))


if __name__ == "__main__":
    main()
