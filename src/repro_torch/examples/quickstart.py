"""Quickstart: N:M structured sparsity end to end (counterpart of
``examples/quickstart.py``).

1. prune a dense matrix to 2:4, compress it (values + 2-bit indices),
2. multiply with every implementation of the port: the plain body, and on
   the card the gather and onehot decode kernels (``nm_spmv``) and the
   tiled kernel (``nm_xwt``), each held within 1e-3 of ``impl="ref"``,
3. train a small sparse LM for a few steps with SR-STE,
4. convert to the compressed serving format and decode.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.sparse_matmul import nm_matmul
from repro_torch.core.sparsity import (compress, decompress, sparsify,
                                       storage_bytes)
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_train_step, named_params
from repro_torch.models import init_model
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    print("== 1. the format =========================================")
    w = torch.randn(8, 16, generator=gen, device=dev)
    sp = compress(w, n=2, m=4)              # 2:4: up to 2 nonzeros per 4
    print("dense shape:", tuple(w.shape), "-> values", tuple(sp.values.shape),
          "+ 2-bit indices", tuple(sp.indices.shape))
    print("storage: dense", w.numel() * 4, "B vs compressed",
          storage_bytes(sp, packed=True), "B")
    assert torch.allclose(decompress(sp), sparsify(w, 2, 4))

    print("== 2. one matmul, every implementation ===================")
    x = torch.randn(4, 16, generator=gen, device=dev)
    y_ref = nm_matmul(x, sp, impl="ref")
    impls = ("plain", "spmv", "spmv_onehot", "xwt") if dev.type == "cuda" \
        else ("plain",)
    for impl in impls:
        y = nm_matmul(x, sp, impl=impl)
        err = float((y - y_ref).abs().max())
        print(f"  {impl:18s} max|err| vs ref = {err:.2e}")
        assert err < 1e-3

    print("== 3. sparse training (SR-STE) ===========================")
    # synthetic-but-learnable data: next token = current token + 1 (mod V)
    cfg = get_config("llama3.2-1b", smoke=True).replace(n_layers=2,
                                                         grad_accum=1)
    model = init_model(cfg, device=dev)
    ocfg = AdamWConfig(master_weights=False)
    opt = adamw_init(named_params(model), ocfg)
    step = make_train_step(cfg, ocfg, base_lr=3e-3, warmup=5)
    rng = np.random.default_rng(0)
    losses = []
    for i in range(30):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32))
                                .astype(np.int32)).to(dev)
        model, opt, metrics = step(model, opt,
                                   {"tokens": toks,
                                    "labels": (toks + 1) % cfg.vocab}, i)
        losses.append(float(metrics["loss"]))
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(learning token+1 rule under 2:4 SR-STE)")

    print("== 4. compressed serving =================================")
    toks, t_prefill, t_decode = serve("llama3.2-1b", smoke=True, batch=2,
                                      prompt_len=16, gen=8, device=dev)
    print(f"generated {toks.shape} tokens; prefill {t_prefill*1e3:.1f} ms, "
          f"decode {t_decode*1e3:.2f} ms/tok")
    print("done.")


if __name__ == "__main__":
    main()
