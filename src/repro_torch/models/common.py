"""Common model building blocks (counterpart of ``repro.models.common``).

Weight convention follows ``core.layers``: linear weights are [out, in] and
the contraction axis (in) is the N:M-sparse axis.  Norm scales are float32,
as in the reference.  Norm scales and the embedding table are parameters
created with ``requires_grad=False`` (the trainer turns them on).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.layers import SparseLinear
from repro_torch.core.sparse_matmul import SparsityConfig


def linear_weight_bytes(p: SparseLinear, cfg: SparsityConfig
                        ) -> Tuple[int, int]:
    """(dense_bytes, stream_bytes) one decode step streams for this linear.

    Converted leaves stream ``w_vals`` (N/M of the dense values) plus the
    packed ceil(log2 M)-bit column indices — the paper's storage format;
    dense leaves stream ``w``.  Biases are excluded on both sides."""
    if p.compressed:
        v = p.w_vals
        nvals = v.numel()
        bits = max(1, (cfg.m - 1).bit_length())       # ceil(log2 M)
        stream = nvals * v.element_size() + -(-nvals * bits // 8)
        dense = nvals * cfg.m // cfg.n * v.element_size()
        return dense, stream
    nbytes = p.w.numel() * p.w.element_size()
    return nbytes, nbytes


# ---------------------------------------------------------------------- norms

class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale.detach(), requires_grad=False)


def rms_norm_init(d: int, device="cuda") -> RMSNorm:
    return RMSNorm(torch.ones(d, dtype=torch.float32, device=device))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5,
             zero_centered: bool = False) -> torch.Tensor:
    """Normalize in float32, scale, cast back to x.dtype.  A gemma-style
    ``zero_centered`` norm scales by ``1 + scale`` (in float32)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = p.scale.float()
    if zero_centered:
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


# ------------------------------------------------------------------ embedding

class Embedding(nn.Module):
    """Token table [vocab, d]; the LM head reads the same table (tied)."""

    def __init__(self, emb: torch.Tensor):
        super().__init__()
        self.emb = nn.Parameter(emb.detach(), requires_grad=False)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device="cuda") -> Embedding:
    emb = torch.randn((vocab, d), generator=gen, device=device,
                      dtype=torch.float32) * d ** -0.5
    return Embedding(emb.to(dtype))


def embed_apply(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    """Table rows of ``tokens``.  A vocab shard (``tp_rows``: the whole
    vocab, tensor-parallel serving) looks up the tokens in its range and
    writes zeros elsewhere; the ranks' results are all-gathered and each
    token takes its owner's row, exactly."""
    if not getattr(p, "tp_rows", None):
        return p.emb[tokens]
    from repro_torch.dist.api import require_mesh
    from repro_torch.dist.collectives import all_gather
    mesh = require_mesh("a vocab-split embedding")
    part = p.emb.shape[0]
    t = tokens.long()
    mine = t - mesh.rank * part
    inside = (mine >= 0) & (mine < part)
    rows = torch.where(inside[..., None], p.emb[mine.clamp(0, part - 1)],
                       torch.zeros((), dtype=p.emb.dtype,
                                   device=p.emb.device))
    every = all_gather(rows, mesh)                    # [n, ..., d]
    owner = (t // part).reshape(1, *t.shape, 1)
    return every.gather(0, owner.expand(1, *rows.shape))[0]


class _HeadMM(torch.autograd.Function):
    """x2 [N, d] @ emb[V, d].T with an f32 output on the card, with a
    backward (``mm`` with ``out_dtype`` has none).  The backward keeps the
    f32 cotangent and multiplies it by the operands in f32, each result
    rounded once to its operand's dtype: the reference's transpose of its
    f32-preferred einsum (an f32 x bf16 dot_general), and the CPU branch's
    autograd."""

    @staticmethod
    def forward(ctx, x2, emb):
        ctx.save_for_backward(x2, emb)
        return torch.mm(x2, emb.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, emb = ctx.saved_tensors
        return (torch.mm(g, emb.float()).to(x2.dtype),
                torch.mm(g.t(), x2.float()).to(emb.dtype))


def lm_head_apply(p: Embedding, x: torch.Tensor,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """logits = x @ emb.T with f32 accumulation and a **float32 output**:
    greedy argmax reads these, and rounding them to bf16 can flip tokens.
    On the card a bf16 table is read as it is (mm with an f32 output),
    never cast to f32 per call.  A vocab shard (``tp_rows``) computes its
    vocab range's logits, all-gathered before the softcap."""
    emb = p.emb
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32 and emb.dtype == torch.float32:
        logits = x2 @ emb.t()
    elif x2.is_cuda:
        logits = _HeadMM.apply(x2, emb)
    else:
        logits = x2.float() @ emb.float().t()
    logits = logits.reshape(*lead, emb.shape[0])
    if getattr(p, "tp_rows", None):
        from repro_torch.dist.api import require_mesh
        from repro_torch.dist.collectives import all_gather_last
        logits = all_gather_last(logits, require_mesh("a vocab-split head"))
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ----------------------------------------------------------------------- rope

def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (cos, sin) [..., dim/2] in f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float().unsqueeze(-1) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Half-split rotation.  x [..., S, H, D]; cos/sin [..., S, D/2]
    broadcast over heads.  A bf16 x times f32 cos/sin computes in f32 and
    casts back to x.dtype once, at the same point as the reference."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos.unsqueeze(-2)
    s = sin.unsqueeze(-2)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (the erf form differs from
    it by ~5e-4)."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": _gelu}


# ------------------------------------------------------------ losses / sampling

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL in f32; labels == ignore_id are masked out."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((lse - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab (first maximal index on ties, as the
    reference)."""
    return logits.argmax(-1).to(torch.int32)
