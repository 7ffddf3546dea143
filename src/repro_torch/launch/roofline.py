"""Roofline terms of one dry-run step (counterpart of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), all per device (the dry-run runs
the step of one rank, so its counts are per device):

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

The counts come from ``launch.op_cost`` (the aten ops of the step, each
kernel launch counted once by its model of the work); the constants are
the NVIDIA H100 SXM's published peaks.  They are counts over peaks, not
measurements.

``LINK_BW`` is NVLink 4 within one host of 8 cards, each way.  A 16x16
mesh spans 32 hosts, whose links between hosts are slower, so the figure
is an upper bound on the collective bandwidth and the collective term a
lower bound on its time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

# NVIDIA H100 SXM5 datasheet: 989 TFLOP/s dense bf16 tensor core (1979
# with 2:4 sparsity), 3.35 TB/s HBM3, 80 GB.
PEAK_FLOPS = 989e12        # bf16 FLOP/s per card, dense
HBM_BW = 3.35e12           # bytes/s per card
HBM_BYTES = 80e9           # bytes of device memory per card
# NVLink 4: 900 GB/s per card in both directions together, 450 GB/s each
# way, between the 8 cards of one host (datasheet).
LINK_BW = 450e9            # bytes/s per card (per-device collective bandwidth)


def _leaves(model):
    """(name, tensor) of every parameter and buffer of ``model``, a tensor
    shared by two modules once."""
    seen = set()
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        if id(t) in seen:
            continue
        seen.add(id(t))
        yield name, t


# ----------------------------------------------------- exact param counting

def param_counts_exact(model, cfg) -> Tuple[int, int]:
    """(total, active) non-embedding params of a (``meta``) model.

    Compressed leaves (w_vals) count at dense-equivalent size (the
    reference's masked-dense product executes full-tile flops).
    Routed-expert weights contribute top_k/n_experts of their size to
    `active`; shared experts and the router are always active.  The rules
    read the reference's key path of each leaf
    (``convert.reference_path``)."""
    from repro_torch.convert import reference_path
    total = expert = embed = 0
    for name, leaf in _leaves(model):
        keys = list(reference_path(name, cfg)[0])
        key = keys[-1]
        if key in ("w_idx", "mask"):
            continue
        size = leaf.numel()
        if key == "w_vals":
            size = size * cfg.sparsity.m // cfg.sparsity.n  # dense-equivalent
        total += size
        if key == "emb":
            embed += size
        if ("moe" in keys and "shared" not in keys
                and key in ("w", "w_vals") and "router" not in keys):
            expert += size
    nonembed = total - embed
    active = nonembed
    if cfg.n_experts and expert:
        active = nonembed - expert + expert * cfg.top_k // cfg.n_experts
    return int(nonembed), int(active)


# ------------------------------------------------- sparse traffic adjustment

def sparse_weight_bytes(model, sparsity) -> Dict[str, float]:
    """Dense vs compressed weight-stream bytes over the model's leaves.

    eligible: leaves named 'w' that the sparsity policy applies to, plus
    compressed (w_vals/w_idx) leaves, by the reference's leaf names (the
    MoE router is its ``router.w``).  Index bytes use the packed
    ceil(log2 M)-bit format (paper Fig 9 accounting)."""
    from repro_torch.convert import reference_path
    n, m = sparsity.n, sparsity.m
    idx_bits = max(1, math.ceil(math.log2(m)))
    dense = compressed = ineligible = 0.0
    for name, leaf in _leaves(model):
        key = reference_path(name)[0][-1]
        size = leaf.numel()
        ib = leaf.element_size()
        if key == "w" and leaf.dim() >= 2 and sparsity.applies(
                leaf.shape[-1], leaf.shape[-2]):
            dense += size * ib
            compressed += size * (n / m) * (ib + idx_bits / 8)
        elif key == "w_vals":
            dense += size * (m / n) * ib
            compressed += size * (ib + idx_bits / 8)
        elif key in ("w_idx", "mask"):
            pass  # folded into w_vals accounting
        else:
            ineligible += size * ib
    return {"dense_bytes": dense, "compressed_bytes": compressed,
            "other_bytes": ineligible,
            "reduction": 1.0 - compressed / dense if dense else 0.0}


# ------------------------------------------------------------- terms report

@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per device
    bytes_accessed: float        # per device
    collective_bytes: float      # per device
    chips: int
    model_flops: float           # 6ND (or 2ND / decode equivalents), global

    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    def dominant(self) -> str:
        terms = {"compute": self.compute_s(), "memory": self.memory_s(),
                 "collective": self.collective_s()}
        return max(terms, key=terms.get)

    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def bound_s(self) -> float:
        return max(self.compute_s(), self.memory_s(), self.collective_s())

    def roofline_fraction(self) -> float:
        """useful-compute seconds / achievable step seconds (bound by the
        dominant term): the perf score the hillclimb moves."""
        useful_s = (self.model_flops / self.chips) / PEAK_FLOPS
        b = self.bound_s()
        return useful_s / b if b else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "coll_bytes_per_dev": self.collective_bytes,
            "compute_s": self.compute_s(),
            "memory_s": self.memory_s(),
            "collective_s": self.collective_s(),
            "dominant": self.dominant(),
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio(),
            "roofline_fraction": self.roofline_fraction(),
        }


def model_flops_for(cfg, shape_kind: str, batch: int, seq: int,
                    n_active: int) -> float:
    """MODEL_FLOPS: 6*N*D train, 2*N*D prefill, 2*N*B decode (per step)."""
    if shape_kind == "train":
        return 6.0 * n_active * batch * seq
    if shape_kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch          # decode: one token per sequence
