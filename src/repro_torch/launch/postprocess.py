"""Recompute roofline-derived fields of stored dry-run records and merge
multiple record files (cells keyed by arch x shape x mesh; later files
win) (counterpart of ``repro.launch.postprocess``).

The step's counts (flops / bytes / collective bytes) are reused
verbatim; MODEL_FLOPS / useful-ratio / roofline-fraction are recomputed
with exact parameter counts from the ``meta`` model (no step is run).

  PYTHONPATH=src python -m repro_torch.launch.postprocess out.json in1.json in2.json…
"""

import json
import sys

from repro_torch.configs import get_config
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.roofline import (RooflineTerms, model_flops_for,
                                         param_counts_exact,
                                         sparse_weight_bytes)
from repro_torch.launch.shapes import SHAPES


def recompute(rec):
    if rec.get("status") != "OK":
        return rec
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    serve = shape.kind != "train"
    model, _, cfg_eff = steps_mod.abstract_params(cfg, serve=serve)
    n_total, n_active = param_counts_exact(model, cfg_eff)
    mf = model_flops_for(cfg, shape.kind, shape.batch, shape.seq, n_active)
    hc = rec["hlo_cost"]
    terms = RooflineTerms(flops=hc["flops"], bytes_accessed=hc["bytes"],
                          collective_bytes=hc["collective_bytes"],
                          chips=rec["chips"], model_flops=mf)
    rec["params_total"] = n_total
    rec["params_active"] = n_active
    rec["roofline"] = terms.as_dict()
    rec["sparse_weights"] = sparse_weight_bytes(model, cfg_eff.sparsity)
    return rec


def main():
    out_path = sys.argv[1]
    cells = {}
    for path in sys.argv[2:]:
        for rec in json.load(open(path)):
            cells[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    records = [recompute(r) for r in cells.values()]
    records.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    with open(out_path, "w") as f:
        json.dump(records, f, indent=1)
    n_ok = sum(r["status"] == "OK" for r in records)
    n_skip = sum(r["status"] == "SKIP" for r in records)
    n_fail = sum(r["status"] == "FAIL" for r in records)
    print(f"{out_path}: {len(records)} cells — {n_ok} OK, {n_skip} SKIP, "
          f"{n_fail} FAIL")


if __name__ == "__main__":
    main()
