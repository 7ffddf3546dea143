"""CNN layers as sparse-dense GEMM — the paper's own evaluation domain
(counterpart of ``repro.models.cnn``).

Each convolution is lowered to a GEMM as in the paper (§IV): the weights
are A = [C_out, C_in*kh*kw] N:M-sparse, the im2col patches B =
[C_in*kh*kw, H_out*W_out*batch].  ``conv2d_sparse`` runs the layer
orientation (patches @ W^T) through ``nm_matmul``: on the card the
``nm_xwt`` kernel, on the CPU the plain path.  The paper's orientation A .
B is ``ops.nm_spmm(values, indices, cols.T)``.

Layout as in the reference: activations NHWC, patch features in (C, KH, KW)
order (channel slowest, ``F.unfold``'s order), patch rows in (b, ho, wo)
order.  "SAME" padding is the reference's (``conv_general_dilated_patches``):
``total = max((ceil(H/s) - 1)*s + k - H, 0)`` split ``total // 2`` low and
the rest high, which ``F.unfold``'s symmetric padding cannot express, so the
input is padded with ``F.pad`` first.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_matmul import nm_matmul
from repro_torch.core.sparsity import NMSparse, compress

CONV_IMPLS = ("auto", "plain", "ref", "xwt")


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial axis under "SAME"."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_input(x_nchw: torch.Tensor, kh: int, kw: int, stride: int,
               padding: str) -> torch.Tensor:
    if padding == "VALID":
        return x_nchw
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    h, w = x_nchw.shape[-2:]
    (ht, hb), (wl, wr) = same_pads(h, kh, stride), same_pads(w, kw, stride)
    return F.pad(x_nchw, (wl, wr, ht, hb))


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME") -> Tuple[torch.Tensor, Tuple[int, int]]:
    """x [B, H, W, C] -> (patches [B*Ho*Wo, C*kh*kw], (Ho, Wo))."""
    b, _, _, c = x.shape
    xp = _pad_input(x.permute(0, 3, 1, 2), kh, kw, stride, padding)
    ho = (xp.shape[2] - kh) // stride + 1
    wo = (xp.shape[3] - kw) // stride + 1
    cols = F.unfold(xp, (kh, kw), stride=stride)         # [B, C*kh*kw, L]
    # dense rows, as the kernels read them (at B = 1 the reshape is a view)
    cols = cols.transpose(1, 2).reshape(b * ho * wo, c * kh * kw)
    return cols.contiguous(), (ho, wo)


def conv2d_sparse(x: torch.Tensor, w_sp: NMSparse, kh: int, kw: int,
                  stride: int = 1, padding: str = "SAME",
                  impl: str = "auto") -> torch.Tensor:
    """Sparse conv via the im2col GEMM: x [B, H, W, C_in] -> [B, Ho, Wo,
    C_out] in x.dtype.  ``w_sp`` has dense_shape [C_out, ckp] with ckp =
    round_up(C_in*kh*kw, M) (the reduction axis zero-padded, as for the
    7x7x3 stem's 147 features); the patches are padded to ckp.  ``impl``:
    'auto' (the ``nm_xwt`` kernel for a CUDA tensor, plain for a CPU one),
    'plain', 'ref' or 'xwt' (the reference's 'xla' / 'pallas' routes)."""
    if impl not in CONV_IMPLS:
        raise ValueError(f"unknown conv impl {impl!r} (one of {CONV_IMPLS})")
    b = x.shape[0]
    cols, (ho, wo) = im2col(x, kh, kw, stride, padding)
    ckp = w_sp.dense_shape[-1]
    if cols.shape[-1] < ckp:
        cols = F.pad(cols, (0, ckp - cols.shape[-1]))
    y = nm_matmul(cols, w_sp, impl=impl)                  # [B*Ho*Wo, C_out]
    return y.reshape(b, ho, wo, -1)


def conv2d_dense(x: torch.Tensor, w_dense: torch.Tensor, c_in: int, kh: int,
                 kw: int, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """The dense convolution of the same (pruned) weights, for comparison:
    w_dense [C_out, ckp] in the patch layout, x [B, H, W, C_in] -> [B, Ho,
    Wo, C_out] through ``F.conv2d`` with the reference's padding."""
    w = w_dense[:, :c_in * kh * kw].reshape(-1, c_in, kh, kw)
    xp = _pad_input(x.permute(0, 3, 1, 2), kh, kw, stride, padding)
    return F.conv2d(xp, w.to(x.dtype), stride=stride).permute(0, 2, 3, 1)


def sparse_conv_init(gen: torch.Generator, c_in: int, c_out: int, kh: int,
                     kw: int, n: int, m: int, dtype=torch.float32,
                     device="cuda") -> NMSparse:
    """N(0, 1/ck) weights [C_out, ck] drawn from ``gen`` (on ``device``),
    ck = C_in*kh*kw zero-padded to a multiple of M, then compressed."""
    ck = c_in * kh * kw
    ckp = -(-ck // m) * m
    w = (torch.randn(c_out, ck, generator=gen, device=device,
                     dtype=torch.float32) * ck ** -0.5).to(dtype)
    if ckp != ck:
        w = F.pad(w, (0, ckp - ck))
    return compress(w, n, m)


# --- representative im2col GEMM dims (R=C_out, K=C_in*kh*kw, C=Ho*Wo*B) ---
# for the three CNNs the paper evaluates; layer ids follow the paper's
# DenseNet121 examples (layers 5, 23, 87) plus per-net coverage.
# (R, K, spatial) with spatial = Ho*Wo for batch 1.  A copy of the
# reference's table.
CNN_LAYER_GEMMS = {
    "densenet121": [
        ("L5", 128, 288, 3136),      # 3x3 conv on 56x56, growth-rate block
        ("L23", 128, 1152, 784),     # deeper dense block, 28x28
        ("L87", 128, 1152, 196),     # 14x14
        ("L1", 64, 147, 12544),      # stem 7x7x3
        ("trans2", 256, 512, 784),   # transition 1x1
    ],
    "resnet50": [
        ("conv2_3x3", 64, 576, 3136),
        ("conv3_3x3", 128, 1152, 784),
        ("conv4_3x3", 256, 2304, 196),
        ("conv5_3x3", 512, 4608, 49),
        ("conv4_1x1", 1024, 256, 196),
    ],
    "inceptionv3": [
        ("mix5_3x3", 64, 432, 1225),
        ("mix6_7x1", 192, 1344, 289),
        ("mix7_3x3", 384, 1152, 64),
        ("stem_3x3", 32, 288, 21609),
        ("mix6_1x1", 192, 768, 289),
    ],
}

# Each GEMM above as the convolution it comes from: (name, C_in, C_out, kh,
# kw, stride, input H = W), SAME padding; K = C_in*kh*kw and spatial =
# ceil(H/stride)^2 reproduce the table.
CNN_LAYER_CONVS = {
    "densenet121": [
        ("L5", 32, 128, 3, 3, 1, 56),
        ("L23", 128, 128, 3, 3, 1, 28),
        ("L87", 128, 128, 3, 3, 1, 14),
        ("L1", 3, 64, 7, 7, 2, 224),
        ("trans2", 512, 256, 1, 1, 1, 28),
    ],
    "resnet50": [
        ("conv2_3x3", 64, 64, 3, 3, 1, 56),
        ("conv3_3x3", 128, 128, 3, 3, 1, 28),
        ("conv4_3x3", 256, 256, 3, 3, 1, 14),
        ("conv5_3x3", 512, 512, 3, 3, 1, 7),
        ("conv4_1x1", 256, 1024, 1, 1, 1, 14),
    ],
    "inceptionv3": [
        ("mix5_3x3", 48, 64, 3, 3, 1, 35),
        ("mix6_7x1", 192, 192, 7, 1, 1, 17),
        ("mix7_3x3", 128, 384, 3, 3, 1, 8),
        ("stem_3x3", 32, 32, 3, 3, 1, 147),
        ("mix6_1x1", 768, 192, 1, 1, 1, 17),
    ],
}
