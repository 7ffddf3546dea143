"""Hillclimb runner: run named optimization variants of the three
selected cells and append before/after records to results/hillclimb.json
(counterpart of ``repro.launch.hillclimb``; the variants are the
reference's ``VARIANTS``, run by the port's dry-run).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --step <name>

Variants (each is one hypothesis -> change -> measure iteration; baselines
come from results/dryrun_final.json):
  whisper_bf16chain   whisper train_4k: bf16 attention chain
  whisper_chunks      whisper train_4k: bf16 chain + larger kv chunks
  qwen_accum4         qwen2-vl train_4k: grad_accum 8 -> 4 (half the FSDP
                      weight regathers)
  qwen_accum2         qwen2-vl train_4k: grad_accum 2
  falcon_gatherc      falcon decode_32k: all-gather the COMPRESSED stream
  falcon_tponly       falcon decode_32k: TP-only weights (no FSDP axis ->
                      zero per-step weight collectives; fits at 7B)
  mistral_bf16chain   mistral train_4k: bf16 attention chain (scale check)
"""

import argparse
import dataclasses
import json
import os

from repro_torch.launch.dryrun import run_cell

VARIANTS = {
    "whisper_bf16chain": dict(
        arch="whisper-small", shape="train_4k", multi_pod=False,
        mutate=lambda c: c.replace(attn_chain_bf16=True)),
    "whisper_chunks": dict(
        arch="whisper-small", shape="train_4k", multi_pod=False,
        mutate=lambda c: c.replace(attn_chain_bf16=True, q_chunk=1024,
                                   kv_chunk=2048)),
    "qwen_accum4": dict(
        arch="qwen2-vl-7b", shape="train_4k", multi_pod=False,
        mutate=lambda c: c.replace(grad_accum=4)),
    "qwen_accum2": dict(
        arch="qwen2-vl-7b", shape="train_4k", multi_pod=False,
        mutate=lambda c: c.replace(grad_accum=2)),
    "falcon_gatherc": dict(
        arch="falcon-mamba-7b", shape="decode_32k", multi_pod=False,
        mutate=lambda c: c.replace(sparsity=dataclasses.replace(
            c.sparsity, gather_compressed=True))),
    "falcon_tponly": dict(
        arch="falcon-mamba-7b", shape="decode_32k", multi_pod=False,
        rules_update={"fsdp": None}),
    "mistral_bf16chain": dict(
        arch="mistral-large-123b", shape="train_4k", multi_pod=False,
        mutate=lambda c: c.replace(attn_chain_bf16=True)),
    # whisper (0.24B) is far too small for 16-way TP on 256 chips: replicate
    # weights, shard the batch over BOTH axes (classic small-model DP).
    "whisper_fulldp": dict(
        arch="whisper-small", shape="train_4k", multi_pod=False,
        rules_update={"act_batch": ("data", "model"), "fsdp": None,
                      "tp": None, "act_heads": None, "act_vocab": None,
                      "act_seq_sp": None, "act_ep": None}),
    "whisper_fulldp_accum1": dict(
        arch="whisper-small", shape="train_4k", multi_pod=False,
        mutate=lambda c: c.replace(grad_accum=1),
        rules_update={"act_batch": ("data", "model"), "fsdp": None,
                      "tp": None, "act_heads": None, "act_vocab": None,
                      "act_seq_sp": None, "act_ep": None}),
    # qwen collective-bound: accum=1 -> one FSDP gather sweep per step
    "qwen_accum1": dict(
        arch="qwen2-vl-7b", shape="train_4k", multi_pod=False,
        mutate=lambda c: c.replace(grad_accum=1)),
    # clean new-default baselines for the three cells (isolates remat_group)
    "whisper_newbase": dict(
        arch="whisper-small", shape="train_4k", multi_pod=False),
    "qwen_newbase": dict(
        arch="qwen2-vl-7b", shape="train_4k", multi_pod=False),
    "falcon_newbase": dict(
        arch="falcon-mamba-7b", shape="decode_32k", multi_pod=False),
    # gather weights once per step; reduce grads once (collectives become
    # accumulation-depth independent)
    "qwen_pregather": dict(
        arch="qwen2-vl-7b", shape="train_4k", multi_pod=False,
        pregather=True),
    "mistral_pregather": dict(
        arch="mistral-large-123b", shape="train_4k", multi_pod=False,
        pregather=True),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--step", required=True, choices=list(VARIANTS) + ["all"])
    ap.add_argument("--out", default="results/hillclimb.json")
    args = ap.parse_args()
    names = list(VARIANTS) if args.step == "all" else [args.step]

    records = []
    if os.path.exists(args.out):
        records = json.load(open(args.out))
    done = {r.get("variant") for r in records}

    for name in names:
        if name in done:
            print(f"[skip] {name} already recorded")
            continue
        v = VARIANTS[name]
        rec = run_cell(v["arch"], v["shape"], v["multi_pod"],
                       mutate=v.get("mutate"),
                       rules_update=v.get("rules_update"),
                       pregather=v.get("pregather", False))
        rec["variant"] = name
        records.append(rec)
        rr = rec.get("roofline", {})
        print(f"[{rec['status']}] {name}: c={rr.get('compute_s', 0):.3f}s "
              f"m={rr.get('memory_s', 0):.2f}s "
              f"coll={rr.get('collective_s', 0):.3f}s "
              f"frac={rr.get('roofline_fraction', 0):.4f}")
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
