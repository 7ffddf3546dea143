"""State-space mixers: Mamba1 (falcon-mamba) and Mamba2 / SSD (zamba2)
(counterpart of ``repro.models.ssm``).

Prefill runs the selective scan in chunks of ``cfg.ssm_chunk`` positions
(the last one may be shorter), carrying the state from chunk to chunk.
Within a chunk, Mamba1 runs a log-depth inclusive scan over the chunk's
(decay, input) pairs (Hillis-Steele: log2(chunk) levels of the
reference's ``associative_scan`` combine, on [B, chunk, d_inner, state]
tensors, so no [B, chunk, chunk, d_inner, state] decay is ever built);
Mamba2 runs the SSD form of every chunk at once (the intra-chunk
quadratic term under a per-head [chunk, chunk] decay, masked before the
exp), then carries the state across chunks in a short loop and adds each
chunk's inter-chunk term.  Decode is the O(1) recurrence, and it writes
the state ``h`` and the conv tail ``conv`` **in place** into the cache
tensors it is given (the engine's CUDA graphs hold them by address).

The rounding points are the reference's: the conv output is cast to the
model dtype before the SiLU, and the recurrence runs in f32.  All
projections are SparseLinears (the paper's technique); the recurrence is
not a GEMM and stays plain torch, as the reference's is plain jnp.

Tensor-parallel serving and training over a mesh's "model" axis (the
reference's specs split the state's channel or head axis and the conv
tail's channels, "act_heads"): every projection keeps whole rows
(``linear_apply`` returns the whole output), and each rank takes its
contiguous part of the channels (Mamba1) or heads (Mamba2) of ``in_proj``'s
x, z (and dt) sections, of the conv and of the f32 leaves, which stay
replicated and are cut at use.  The conv, the scan and the state are the
rank's own; ``x_proj`` reads the whole conv output (an all-gather), and
Mamba2's gated norm the whole gated output (another), so no contraction is
split and each element sums in the one-device order.  B and C, read by
every channel, sum their cotangent over the ranks in training.

A prompt shorter than the conv's ``K - 1`` leaves a conv tail padded with
zeros on the left (the positions before the prompt), the state that
decode from an empty cache would hold; the reference slices the prompt's
own positions only and returns a shorter tail there.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.layers import SparseLinear, linear_apply, linear_init
from repro_torch.dist.api import local_part, require_mesh
from repro_torch.dist.collectives import (all_gather_last, reduce_grad,
                                          split_last)
from repro_torch.models.common import RMSNorm, rms_norm, rms_norm_init
from repro_torch.models.config import ArchConfig

Cache = Dict[str, torch.Tensor]


class Mamba1(nn.Module):
    """Mamba1 mixer: ``in_proj`` (d -> 2 d_inner: x and the gate z),
    a depthwise causal conv, ``x_proj`` (d_inner -> dt_rank + 2 state: dt,
    B, C), ``dt_proj`` (dt_rank -> d_inner, with a bias), ``out_proj``;
    ``conv_w`` [d_inner, K], ``conv_b``, ``A_log`` [d_inner, state] and
    ``D`` are f32 parameters (created with ``requires_grad=False``, as
    every parameter of the port: the trainer turns them on)."""

    def __init__(self, in_proj: SparseLinear, x_proj: SparseLinear,
                 dt_proj: SparseLinear, out_proj: SparseLinear,
                 conv_w: torch.Tensor, conv_b: torch.Tensor,
                 A_log: torch.Tensor, D: torch.Tensor):
        super().__init__()
        self.in_proj, self.x_proj = in_proj, x_proj
        self.dt_proj, self.out_proj = dt_proj, out_proj
        _f32_params(self, conv_w=conv_w, conv_b=conv_b, A_log=A_log, D=D)


class Mamba2(nn.Module):
    """Mamba2 mixer: a packed ``in_proj`` (d -> x, z, B, C, dt), the
    depthwise causal conv over x, per-head ``A_log`` / ``D`` / ``dt_bias``
    (f32 parameters, as Mamba1's), the gated RMS ``norm`` and
    ``out_proj``."""

    def __init__(self, in_proj: SparseLinear, out_proj: SparseLinear,
                 norm: RMSNorm, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 A_log: torch.Tensor, D: torch.Tensor,
                 dt_bias: torch.Tensor):
        super().__init__()
        self.in_proj, self.out_proj, self.norm = in_proj, out_proj, norm
        _f32_params(self, conv_w=conv_w, conv_b=conv_b, A_log=A_log, D=D,
                    dt_bias=dt_bias)


def _f32_params(mod: nn.Module, **leaves: torch.Tensor) -> None:
    """The mixer's f32 leaves as parameters, gradients off until the
    trainer turns them on (they are trained, as the reference's)."""
    for name, t in leaves.items():
        mod.register_parameter(name, nn.Parameter(t.detach(),
                                                  requires_grad=False))


def _conv_init(gen, di: int, ck: int, device):
    w = torch.randn((di, ck), generator=gen, device=device,
                    dtype=torch.float32) * 0.1
    return w, torch.zeros(di, dtype=torch.float32, device=device)


def mamba1_init(gen: torch.Generator, cfg: ArchConfig, dtype,
                device="cuda") -> Mamba1:
    d, di, st, dtr = cfg.d_model, cfg.dinner(), cfg.ssm_state, cfg.dtrank()
    sp = cfg.sparsity
    in_proj = linear_init(gen, d, 2 * di, sp, dtype, device)
    conv_w, conv_b = _conv_init(gen, di, cfg.conv_kernel, device)
    x_proj = linear_init(gen, di, dtr + 2 * st, sp, dtype, device)
    dt_proj = linear_init(gen, dtr, di, sp, dtype, device, use_bias=True)
    out_proj = linear_init(gen, di, d, sp, dtype, device)
    a = torch.arange(1, st + 1, dtype=torch.float32, device=device)
    return Mamba1(in_proj, x_proj, dt_proj, out_proj, conv_w, conv_b,
                  torch.log(a)[None, :].repeat(di, 1),
                  torch.ones(di, dtype=torch.float32, device=device))


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, dtype,
                device="cuda") -> Mamba2:
    d, di, st, nh = cfg.d_model, cfg.dinner(), cfg.ssm_state, cfg.nheads_ssm()
    sp = cfg.sparsity
    in_proj = linear_init(gen, d, 2 * di + 2 * st + nh, sp, dtype, device)
    conv_w, conv_b = _conv_init(gen, di, cfg.conv_kernel, device)
    out_proj = linear_init(gen, di, d, sp, dtype, device)
    f32 = dict(dtype=torch.float32, device=device)
    return Mamba2(in_proj, out_proj, rms_norm_init(di, device), conv_w,
                  conv_b, torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
                  torch.ones(nh, **f32), torch.zeros(nh, **f32))


def mamba1_cache_init(cfg: ArchConfig, batch: int, dtype,
                      device="cuda") -> Cache:
    di, st, ck = cfg.dinner(), cfg.ssm_state, cfg.conv_kernel
    return {"h": torch.zeros((batch, di, st), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, ck - 1, di), dtype=dtype,
                                device=device)}


def mamba2_cache_init(cfg: ArchConfig, batch: int, dtype,
                      device="cuda") -> Cache:
    di, st, ck, nh = (cfg.dinner(), cfg.ssm_state, cfg.conv_kernel,
                      cfg.nheads_ssm())
    return {"h": torch.zeros((batch, nh, di // nh, st), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, ck - 1, di), dtype=dtype,
                                device=device)}


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence, in f32, cast back to x's
    dtype.  x [B, S, C], w [C, K], b [C] -> (y [B, S, C], tail [B, K-1, C]).

    Prefill (``state`` None) pads K - 1 zeros on the left; ``tail`` is the
    last K - 1 positions of the padded input (the decode state after the
    prompt).  Decode (S == 1) reads ``state`` [B, K-1, C] and shifts the
    new input into it **in place**; ``tail`` is ``state`` itself."""
    k = w.shape[1]
    wf, bf = w.float(), b.float()
    if state is not None:
        buf = torch.cat([state, x.to(state.dtype)], dim=1)      # [B, K, C]
        y = torch.einsum("bkc,ck->bc", buf.float(), wf) + bf
        state.copy_(buf[:, 1:])
        return y[:, None, :].to(x.dtype), state
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = xp[:, 0:s].float() * wf[:, 0]
    for i in range(1, k):
        y = y + xp[:, i:i + s].float() * wf[:, i]
    return (y + bf).to(x.dtype), xp[:, s:s + k - 1]


def _chunks(s: int, chunk: int):
    return [(c0, min(c0 + chunk, s)) for c0 in range(0, s, max(chunk, 1))]


def mamba1_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                xs: torch.Tensor, a: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan from a zero state.  dt / xs [B, S, di] f32, bmat /
    cmat [B, S, st] f32, a [di, st] f32 (negative) -> (y [B, S, di],
    h_last [B, di, st]).  Per chunk, h_t = exp(dt_t a) h_{t-1} + dt_t x_t
    B_t for every t at once by an inclusive scan of the pairs (exp(dt a),
    dt x B) under (a_l, b_l) o (a_r, b_r) = (a_l a_r, b_l a_r + b_r).
    Nothing is written in place, so the scan runs under autograd."""
    bb, s, di = xs.shape
    h = torch.zeros((bb, di, a.shape[1]), dtype=torch.float32,
                    device=xs.device)
    ys = []
    for c0, c1 in _chunks(s, chunk):
        dtk = dt[:, c0:c1]
        acc_a = torch.exp(dtk[..., None] * a)                   # [B,c,di,st]
        acc_b = (dtk * xs[:, c0:c1])[..., None] * bmat[:, c0:c1, None, :]
        off = 1
        while off < c1 - c0:
            # each level is new tensors (the untouched head, the combined
            # tail), so autograd keeps every level it differentiates
            acc_b = torch.cat([acc_b[:, :off], acc_b[:, :-off] * acc_a[:, off:]
                               + acc_b[:, off:]], dim=1)
            acc_a = torch.cat([acc_a[:, :off],
                               acc_a[:, :-off] * acc_a[:, off:]], dim=1)
            off *= 2
        h_all = acc_b + acc_a * h[:, None]
        ys.append(torch.einsum("bcds,bcs->bcd", h_all, cmat[:, c0:c1]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def mamba1_step(h: torch.Tensor, dt: torch.Tensor, x: torch.Tensor,
                bvec: torch.Tensor, cvec: torch.Tensor, a: torch.Tensor
                ) -> torch.Tensor:
    """One decode step of the Mamba1 recurrence, all f32: h [B, di, st] <-
    exp(dt a) h + dt x B **in place**; returns y [B, di] = h . C.  dt / x
    [B, di], bvec / cvec [B, st], a [di, st]."""
    da = torch.exp(dt[..., None] * a[None])
    h.copy_(da * h + (dt * x)[..., None] * bvec[:, None, :])
    return torch.einsum("bds,bs->bd", h, cvec)


def _mine(t: torch.Tensor, heads, dim: int = -1) -> torch.Tensor:
    """This rank's contiguous part of ``t``'s axis ``dim`` when ``heads``
    split the mixer's channels (its cotangent all-gathered back to the
    whole axis), else ``t``."""
    if not heads:
        return t
    mesh = require_mesh("split SSM channels")
    return split_last(t.movedim(dim, -1), mesh).movedim(-1, dim)


def _whole(t: torch.Tensor, heads) -> torch.Tensor:
    """Every rank's channels of ``t`` [..., local], in rank order, when
    ``heads`` split them, else ``t``."""
    if not heads:
        return t
    return all_gather_last(t, require_mesh("split SSM channels"))


def _shared(t: torch.Tensor, heads) -> torch.Tensor:
    """``t``, read by this rank's channels only: its cotangent is summed
    over the ranks when ``heads`` split them."""
    if not heads:
        return t
    return reduce_grad(t, require_mesh("split SSM channels"))


def mamba1_apply(p: Mamba1, x: torch.Tensor, cfg: ArchConfig, *,
                 cache: Optional[Cache] = None, return_state: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x [B, S, d] -> (y, state).  Decode when ``cache`` ({"h", "conv"}
    views, S == 1) is given: the cache is updated in place and returned;
    prefill otherwise, ``return_state`` returning the final {"h", "conv"}
    for decode.  Under a mesh that splits the channels the state, the conv
    tail and the scan are this rank's (module docstring)."""
    b, s, _ = x.shape
    di, st, dtr = cfg.dinner(), cfg.ssm_state, cfg.dtrank()
    sp = cfg.sparsity
    heads = local_part("act_heads", di)     # this rank's channels, if split
    xz = linear_apply(p.in_proj, x, sp)
    xin, z = _mine(xz[..., :di], heads), _mine(xz[..., di:], heads)
    a = -torch.exp(_mine(p.A_log, heads, 0))                    # [di, st]
    xc, tail = causal_conv(xin, _mine(p.conv_w, heads, 0),
                           _mine(p.conv_b, heads),
                           None if cache is None else cache["conv"])
    xc = F.silu(xc.float())
    proj = linear_apply(p.x_proj, _whole(xc.to(x.dtype), heads), sp)
    dt_r = proj[..., :dtr]
    bm = _shared(proj[..., dtr:dtr + st], heads)
    cm = _shared(proj[..., dtr + st:], heads)
    dt = F.softplus(linear_apply(p.dt_proj, dt_r, sp,
                                 local=bool(heads)).float())
    if cache is None:
        y, h_last = mamba1_scan(dt, bm.float(), cm.float(), xc, a,
                                cfg.ssm_chunk)
        new_cache = {"h": h_last, "conv": tail} if return_state else None
    else:
        y = mamba1_step(cache["h"], dt[:, 0], xc[:, 0], bm[:, 0].float(),
                        cm[:, 0].float(), a)[:, None]
        new_cache = cache
    y = y + _mine(p.D, heads) * xc
    y = (y * F.silu(z.float())).to(x.dtype)
    return linear_apply(p.out_proj, _whole(y, heads), sp), new_cache


def _segsum_decay(ld: torch.Tensor) -> torch.Tensor:
    """ld [..., c, nh] -> L [..., c, c, nh], L[t, u] = exp(sum_{u<v<=t}
    ld_v) for u <= t, else 0 (masked before the exp, as the reference)."""
    cs = torch.cumsum(ld, dim=-2)
    diff = cs[..., :, None, :] - cs[..., None, :, :]
    c = ld.shape[-2]
    tri = torch.ones((c, c), dtype=torch.bool, device=ld.device).tril()
    return torch.exp(torch.where(tri[:, :, None], diff,
                                 torch.full_like(diff, -1e30)))


def mamba2_ssd(xc: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor, chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunks from a zero state.  xc [B, S, nh, hd], dt [B, S, nh],
    bmat / cmat [B, S, st] (f32), a [nh] -> (y [B, S, nh, hd], h_last
    [B, nh, hd, st]).  The sequence is padded to whole chunks with dt = 0
    (decay 1, no input: the state passes the padding unchanged)."""
    bb, s, nh, hd = xc.shape
    st = bmat.shape[-1]
    c = max(1, min(chunk, s))
    nc = -(-s // c)
    pad = nc * c - s

    def chunked(t):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((bb, nc, c) + tuple(t.shape[2:]))

    xk, dk, bk, ck = chunked(xc), chunked(dt), chunked(bmat), chunked(cmat)
    ld = dk * a                                                 # [B,n,c,nh]
    ldc = torch.cumsum(ld, dim=2)
    cb = torch.einsum("bkts,bkus->bktu", ck, bk)                # [B,n,c,c]
    m = cb[..., None] * _segsum_decay(ld)                       # [B,n,c,c,nh]
    y = torch.einsum("bktun,bkunh->bktnh", m, dk[..., None] * xk)
    # each chunk's own contribution to the state at its end
    rem = torch.exp(ldc[:, :, -1:, :] - ldc)
    upd = torch.einsum("bktn,bktnh,bkts->bknhs", dk * rem, xk, bk)
    last = torch.exp(ldc[:, :, -1])                             # [B,n,nh]
    h = torch.zeros((bb, nh, hd, st), dtype=torch.float32, device=xc.device)
    starts = []
    for i in range(nc):
        starts.append(h)
        h = h * last[:, i, :, None, None] + upd[:, i]
    hs = torch.stack(starts, dim=1)                             # [B,n,nh,hd,st]
    y = y + torch.einsum("bkts,bknhs,bktn->bktnh", ck, hs, torch.exp(ldc))
    return y.reshape(bb, nc * c, nh, hd)[:, :s], h


def mamba2_step(h: torch.Tensor, dt: torch.Tensor, x: torch.Tensor,
                bvec: torch.Tensor, cvec: torch.Tensor, a: torch.Tensor
                ) -> torch.Tensor:
    """One decode step of the Mamba2 recurrence, all f32: h [B, nh, hd,
    st] <- exp(dt a) h + dt x B (a scalar decay per head) **in place**;
    returns y [B, nh, hd] = h . C.  dt [B, nh], x [B, nh, hd], bvec / cvec
    [B, st], a [nh]."""
    da = torch.exp(dt * a)                                      # [B, nh]
    dbx = torch.einsum("bn,bnh,bs->bnhs", dt, x, bvec)
    h.copy_(h * da[..., None, None] + dbx)
    return torch.einsum("bnhs,bs->bnh", h, cvec)


def mamba2_apply(p: Mamba2, x: torch.Tensor, cfg: ArchConfig, *,
                 cache: Optional[Cache] = None, return_state: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """As ``mamba1_apply``, for the Mamba2 mixer (state [B, nh, hd, st]);
    under a mesh its heads are split, B and C are every head's."""
    b, s, _ = x.shape
    di, st, nh = cfg.dinner(), cfg.ssm_state, cfg.nheads_ssm()
    hd = di // nh
    sp = cfg.sparsity
    heads = local_part("act_heads", nh)     # this rank's heads, if split
    if bool(heads) != bool(local_part("act_heads", di)):
        raise ValueError(f"Mamba2: the mesh splits the conv tail's {di} "
                         f"channels and the state's {nh} heads differently")
    parts = heads[0] if heads else 1
    zxbcdt = linear_apply(p.in_proj, x, sp)
    xin = _mine(zxbcdt[..., :di], heads)
    z = _mine(zxbcdt[..., di:2 * di], heads)
    bmat = _shared(zxbcdt[..., 2 * di:2 * di + st].float(), heads)
    cmat = _shared(zxbcdt[..., 2 * di + st:2 * di + 2 * st].float(), heads)
    dt = F.softplus(_mine(zxbcdt[..., 2 * di + 2 * st:], heads).float()
                    + _mine(p.dt_bias, heads))
    a = -torch.exp(_mine(p.A_log, heads))                       # [nh]
    xc, tail = causal_conv(xin, _mine(p.conv_w, heads, 0),
                           _mine(p.conv_b, heads),
                           None if cache is None else cache["conv"])
    xc = F.silu(xc.float()).reshape(b, s, nh // parts, hd)
    if cache is None:
        y, h_last = mamba2_ssd(xc, dt, bmat, cmat, a, cfg.ssm_chunk)
        new_cache = {"h": h_last, "conv": tail} if return_state else None
    else:
        y = mamba2_step(cache["h"], dt[:, 0], xc[:, 0], bmat[:, 0],
                        cmat[:, 0], a)[:, None]
        new_cache = cache
    y = y + _mine(p.D, heads)[:, None] * xc
    y = y.reshape(b, s, di // parts) * F.silu(z.float())
    y = rms_norm(p.norm, _whole(y.to(x.dtype), heads), cfg.norm_eps)
    return linear_apply(p.out_proj, y, sp), new_cache
