"""Carry reference-initialized weights into the port.

``from_reference_params`` takes the reference ``init_model`` parameter tree
*as numpy arrays* (the caller maps every leaf through ``np.asarray``) and
returns the port's ``DenseLM`` (dense family) or ``MoELM`` (MoE family:
``dense_layers`` and ``layers`` with MLA or GQA attention and a ``moe``
subtree of router, stacked experts and shared MLP; gemma2's stacked
``pairs`` {"local", "global"} become the blocks 2i and 2i + 1, with their
post norms ``pn1`` / ``pn2``), ``SSMLM`` (the SSM family: stacked Mamba1
``layers``) or ``HybridLM`` (the hybrid family: ``groups`` stacked
[G, P, ...], the one ``shared`` dense block, a ``tail`` [T, ...]) or
``EncDecLM`` (the audio family: stacked ``enc_layers`` and ``dec_layers``,
a decoder layer's ``self`` / ``cross`` attention and ``mlp`` sub-trees;
the vlm family is a ``DenseLM``).  Linear leaves may be dense ``{"w"}`` or
compressed ``{"w_vals", "w_idx"}``, each with its bias ``b`` where it has
one (the qkv biases); the stacked
``[L, ...]`` layer leaves are split per layer (a group stack per group
and member), an expert stack keeps its ``[E, ...]`` axis; a mixer's
conv, ``A_log``, ``D`` and ``dt_bias`` stay f32, ``dt_proj`` keeps its
bias.  This is how the parity tests feed both packages the
same weights (their random generators cannot agree).
``from_reference_nmsparse`` carries one reference ``NMSparse`` (a CNN
layer's weights, say) the same way.  A 'fixed' linear's boolean ``mask``
comes along as the port's mask buffer.

Training state: ``from_reference_opt_state`` maps the reference's AdamW
state {"mu", "nu", "master", "step"} onto the port's dicts keyed by the
model's parameter names, and ``to_reference_tree`` /
``to_reference_opt_state`` go the other way (per-layer tensors stacked
back into the reference's [L, ...] leaves, as numpy), for the tests'
comparisons.  ``reference_path`` names, family by family from the config,
where each port parameter lives in the reference's tree, so each
direction is the exact inverse of ``from_reference_params``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.layers import SparseLinear, StackedLinear
from repro_torch.core.sparsity import NMSparse
from repro_torch.models.attention import GQA, MLA
from repro_torch.models.common import Embedding, RMSNorm
from repro_torch.models.config import ArchConfig
from repro_torch.models.ffn import MLP, MoE
from repro_torch.models.ssm import Mamba1, Mamba2
from repro_torch.models.transformer import (LM, DecBlock, DenseBlock, DenseLM,
                                            EncBlock, EncDecLM, HybridLM,
                                            MoEBlock, MoELM, SSMBlock, SSMLM,
                                            _check_family)


def to_torch(a: np.ndarray, device="cuda") -> torch.Tensor:
    """numpy -> torch, bit for bit.  A bfloat16 array (the ml_dtypes type
    numpy reports as ``bfloat16``, which ``torch.from_numpy`` rejects) is
    reinterpreted through its 16-bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_reference_nmsparse(sp, device="cuda") -> NMSparse:
    """The reference's ``NMSparse`` (values, int8 indices, n, m,
    dense_shape; its arrays are read through ``np.asarray``) -> the port's,
    bit for bit, on ``device``."""
    device = resolve_device(device)
    return NMSparse(values=to_torch(np.asarray(sp.values), device),
                    indices=to_torch(np.asarray(sp.indices), device),
                    n=int(sp.n), m=int(sp.m),
                    dense_shape=tuple(int(d) for d in sp.dense_shape))


def _linear(tree: Mapping[str, np.ndarray], device,
            cls=SparseLinear) -> SparseLinear:
    kw = {k: to_torch(v, device) for k, v in tree.items()}
    return cls(**kw)


def _layer(tree: Mapping[str, Any], *i: int) -> Dict[str, Any]:
    """Slice layer ``i`` out of a stacked [L, ...] subtree (``g, j`` out
    of a [G, P, ...] one)."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, *i) for k, v in tree.items()}
    return tree[i]


def _norm(tree, device) -> RMSNorm:
    return RMSNorm(to_torch(tree["scale"], device))


def _attn(a: Mapping[str, Any], cfg: ArchConfig, device):
    names = ("wq", "wdkv", "wuk", "wuv", "wo") if cfg.mla \
        else ("wq", "wk", "wv", "wo")
    return (MLA if cfg.mla else GQA)(*(_linear(a[k], device) for k in names))


def _mlp(f: Mapping[str, Any], device) -> MLP:
    return MLP(*(_linear(f[k], device) for k in ("wg", "wu", "wd")))


def _dense_block(lt, cfg: ArchConfig, device) -> DenseBlock:
    post = ((_norm(lt["pn1"], device), _norm(lt["pn2"], device))
            if "pn1" in lt else ())
    return DenseBlock(_norm(lt["ln1"], device), _attn(lt["attn"], cfg, device),
                      _norm(lt["ln2"], device), _mlp(lt["mlp"], device),
                      *post)


def _moe_block(lt, cfg: ArchConfig, device) -> MoEBlock:
    mt = lt["moe"]
    stacks = (_linear(mt[k], device, StackedLinear) for k in ("wg", "wu", "wd"))
    moe = MoE(to_torch(mt["router"]["w"], device), *stacks,
              shared=_mlp(mt["shared"], device) if "shared" in mt else None)
    return MoEBlock(_norm(lt["ln1"], device), _attn(lt["attn"], cfg, device),
                    _norm(lt["ln2"], device), moe,
                    _mlp(lt["mlp"], device) if "mlp" in lt else None)


def _ssm_block(lt, cfg: ArchConfig, device) -> SSMBlock:
    mt = lt["mixer"]
    f32 = {k: to_torch(mt[k], device)
           for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias") if k in mt}
    if cfg.mamba_version == 1:
        mixer = Mamba1(*(_linear(mt[k], device)
                         for k in ("in_proj", "x_proj", "dt_proj",
                                   "out_proj")), **f32)
    else:
        mixer = Mamba2(_linear(mt["in_proj"], device),
                       _linear(mt["out_proj"], device),
                       _norm(mt["norm"], device), **f32)
    return SSMBlock(_norm(lt["ln"], device), mixer)


def _enc_block(lt, cfg: ArchConfig, device) -> EncBlock:
    return EncBlock(_norm(lt["ln1"], device), _attn(lt["attn"], cfg, device),
                    _norm(lt["ln2"], device), _mlp(lt["mlp"], device))


def _dec_block(lt, cfg: ArchConfig, device) -> DecBlock:
    return DecBlock(_norm(lt["ln1"], device), _attn(lt["self"], cfg, device),
                    _norm(lt["ln2"], device), _attn(lt["cross"], cfg, device),
                    _norm(lt["ln3"], device), _mlp(lt["mlp"], device))


def from_reference_params(tree: Mapping[str, Any], cfg: ArchConfig,
                          device="cuda") -> LM:
    """Reference parameter tree of any family (numpy leaves) -> the port's
    model."""
    _check_family(cfg)
    device = resolve_device(device)
    embed = Embedding(to_torch(tree["embed"]["emb"], device))
    lnf = _norm(tree["lnf"], device)
    if cfg.family == "audio":
        return EncDecLM(
            embed, [_enc_block(_layer(tree["enc_layers"], i), cfg, device)
                    for i in range(cfg.enc_layers)],
            _norm(tree["enc_lnf"], device),
            [_dec_block(_layer(tree["dec_layers"], i), cfg, device)
             for i in range(cfg.n_layers)], lnf)
    if cfg.family == "ssm":
        return SSMLM(embed, [_ssm_block(_layer(tree["layers"], i), cfg,
                                        device)
                             for i in range(cfg.n_layers)], lnf)
    if cfg.family == "hybrid":
        groups = []
        if "groups" in tree:
            g, per = np.shape(tree["groups"]["ln"]["scale"])[:2]
            groups = [[_ssm_block(_layer(tree["groups"], i, j), cfg, device)
                       for j in range(per)] for i in range(g)]
        tail = []
        if "tail" in tree:
            tail = [_ssm_block(_layer(tree["tail"], i), cfg, device)
                    for i in range(np.shape(tree["tail"]["ln"]["scale"])[0])]
        shared = (_dense_block(tree["shared"], cfg, device)
                  if "shared" in tree else None)
        return HybridLM(embed, groups, shared, tail, lnf)
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        dense = [_dense_block(_layer(tree["dense_layers"], i), cfg, device)
                 for i in range(nd)]
        moe = [_moe_block(_layer(tree["layers"], i), cfg, device)
               for i in range(cfg.n_layers - nd)]
        return MoELM(embed, dense, moe, lnf)
    if "pairs" in tree:
        # gemma2: stacked (local, global) pairs -> blocks in depth order
        blocks = [_dense_block(_layer(tree["pairs"][kind], i), cfg, device)
                  for i in range(cfg.n_layers // 2)
                  for kind in ("local", "global")]
        return DenseLM(embed, blocks, lnf)
    return DenseLM(embed, [_dense_block(_layer(tree["layers"], i), cfg, device)
                           for i in range(cfg.n_layers)], lnf)


_STACKS = {"layers": 1, "dense_layers": 1, "enc_layers": 1, "groups": 2,
           "tail": 1}        # a port module list -> its stacked axes


def reference_path(name: str, cfg: Optional[ArchConfig] = None
                   ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Where port parameter ``name`` lives in the reference's tree: (the
    key path, the index into the stacked leaf there), the exact inverse of
    ``from_reference_params`` for ``cfg``'s family (``None``: the dense
    family's plain ``layers``).  ``layers.3.attn.wq.w`` is
    (("layers", "attn", "wq", "w"), (3,)); gemma2's block 2i / 2i + 1 is
    pair i's "local" / "global"; the hybrid's ``groups.g.j`` is [g, j] of
    "groups", ``tail.t`` [t] of "tail", ``shared`` unstacked; the audio
    family's decoder ``layers`` are "dec_layers" (their ``attn`` is
    "self"); an MoE ``router`` is the leaf ``router.w``."""
    parts = name.split(".")
    head, rest = (parts[0],), parts[1:]
    idx: Tuple[int, ...] = ()
    if parts[0] in _STACKS:
        n = _STACKS[parts[0]]
        idx, rest = tuple(int(i) for i in rest[:n]), rest[n:]
        family = cfg.family if cfg is not None else "dense"
        if parts[0] == "layers" and family == "audio":
            head = ("dec_layers",)
            rest = ["self"] + rest[1:] if rest[0] == "attn" else rest
        elif parts[0] == "layers" and cfg is not None \
                and cfg.local_global_period:
            head = ("pairs", ("local", "global")[idx[0] % 2])
            idx = (idx[0] // 2,)
    if rest and rest[-1] == "router":
        rest = rest + ["w"]
    return head + tuple(rest), idx


def _reference_leaf(tree: Mapping[str, Any], name: str,
                    cfg: Optional[ArchConfig] = None) -> np.ndarray:
    """The reference leaf of port parameter ``name`` (``reference_path``):
    ``layers.3.attn.wq.w`` is layer 3 of ``tree["layers"]["attn"]["wq"]
    ["w"]``."""
    path, idx = reference_path(name, cfg)
    node = tree
    for key in path:
        node = node[key]
    return np.asarray(node)[idx] if idx else np.asarray(node)


def from_reference_opt_state(tree: Mapping[str, Any], model: LM,
                             device="cuda",
                             cfg: Optional[ArchConfig] = None
                             ) -> Dict[str, Any]:
    """The reference's AdamW state (numpy leaves) of ``cfg``'s family
    (``None``: dense) -> the port's: "mu", "nu" (and "master" when present)
    as {parameter name: tensor} in the order of
    ``model.named_parameters()``, "step" an int32 0-d tensor."""
    device = resolve_device(device)
    names = [n for n, _ in model.named_parameters()]
    out: Dict[str, Any] = {
        part: {n: to_torch(_reference_leaf(tree[part], n, cfg), device)
               for n in names}
        for part in ("mu", "nu", "master") if part in tree}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=device)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_reference_tree(named: Mapping[str, torch.Tensor],
                      cfg: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """{port parameter name: tensor} -> the reference's nested tree of
    numpy leaves (bf16 read as f32) for ``cfg``'s family (``None``:
    dense): each name goes where ``reference_path`` puts it, the per-layer
    tensors of a stacked leaf stacked along its leading axes in index
    order."""
    tree: Dict[str, Any] = {}
    stacks: Dict[tuple, Dict[tuple, np.ndarray]] = {}
    for name, t in named.items():
        path, idx = reference_path(name, cfg)
        if idx:
            stacks.setdefault(path, {})[idx] = _numpy(t)
        else:
            _set(tree, path, _numpy(t))
    for path, per in stacks.items():
        dims = tuple(max(i[a] for i in per) + 1
                     for a in range(len(next(iter(per)))))
        if len(per) != int(np.prod(dims)):
            raise ValueError(f"{'.'.join(path)}: {len(per)} of the "
                             f"{dims} stacked entries")
        leaf = np.stack([per[i] for i in np.ndindex(*dims)])
        _set(tree, path, leaf.reshape(dims + leaf.shape[1:]))
    return tree


def _set(tree: Dict[str, Any], path: tuple, leaf) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = leaf


def to_reference_opt_state(state: Mapping[str, Any],
                           cfg: Optional[ArchConfig] = None
                           ) -> Dict[str, Any]:
    """The port's AdamW state -> the reference's tree (numpy leaves) of
    ``cfg``'s family (``None``: dense)."""
    out = {part: to_reference_tree(state[part], cfg)
           for part in ("mu", "nu", "master") if part in state}
    out["step"] = np.asarray(int(state["step"]), np.int32)
    return out
