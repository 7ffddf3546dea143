"""Structured-sparse CNN inference, the paper's own domain (counterpart of
``examples/sparse_cnn_inference.py``).

  PYTHONPATH=src python -m repro_torch.launch.cnn [--device cpu]

Builds a small conv stack with 2:4-pruned f32 weights (random, from
``--seed``), runs it through the im2col + sparse-GEMM path
(``conv2d_sparse``: the ``nm_xwt`` kernel on the card, the plain path on
the CPU) and through a dense convolution of the same pruned weights, and
prints their max error, milliseconds per forward of each, and the
compressed against the dense weight bytes.  Runs on the card
(``--device cuda``, the default; raises without one) unless asked for the
CPU; on the card TF32 is switched off so the dense f32 convolution is the
full-precision comparison.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core.sparsity import decompress, storage_bytes
from repro_torch.models.cnn import conv2d_dense, conv2d_sparse, sparse_conv_init

# (c_in, c_out, k, stride): a DenseNet-ish stem and blocks, the example's
LAYERS = [(3, 32, 3, 1), (32, 64, 3, 2), (64, 64, 3, 1), (64, 128, 3, 2)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ws = [sparse_conv_init(gen, ci, co, k, k, n=2, m=4, device=dev)
          for ci, co, k, _ in LAYERS]
    x = torch.randn(2, 64, 64, 3, generator=gen, device=dev)
    dense_ws = [decompress(w) for w in ws]

    def net_sparse(h):
        for (_, _, k, s), w in zip(LAYERS, ws):
            h = torch.relu(conv2d_sparse(h, w, k, k, stride=s))
        return h

    def net_dense(h):
        for (ci, _, k, s), wd in zip(LAYERS, dense_ws):
            h = torch.relu(conv2d_dense(h, wd, ci, k, k, stride=s))
        return h

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    y_s, y_d = net_sparse(x), net_dense(x)
    err = float((y_s - y_d).abs().max())
    print(f"sparse-vs-dense max|err| = {err:.2e}  (same pruned weights, "
          f"output {tuple(y_s.shape)}, {dev.type})")
    for f, name in ((net_sparse, "sparse"), (net_dense, "dense")):
        f(x)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            f(x)
        sync()
        print(f"{name:7s}: {(time.perf_counter() - t0) / args.iters * 1e3:7.3f}"
              f" ms/fwd")
    sp_bytes = sum(storage_bytes(w, packed=True) for w in ws)
    d_bytes = sum(w.dense_shape[0] * w.dense_shape[1] * 4 for w in ws)
    print(f"weights: dense {d_bytes / 1e3:.0f} KB -> compressed "
          f"{sp_bytes / 1e3:.0f} KB ({sp_bytes / d_bytes:.2%})")


if __name__ == "__main__":
    main()
