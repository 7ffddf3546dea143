"""The assigned input-shape set and per-(arch x shape) applicability
(counterpart of ``repro.launch.shapes``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    batch: int
    kind: str        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ALL_SHAPES = list(SHAPES)


def cell_supported(cfg: ArchConfig, shape: str) -> Tuple[bool, Optional[str]]:
    """long_500k needs sub-quadratic attention: runs for SSM/hybrid only
    (zamba2's shared attention uses a sliding window — DESIGN.md §4)."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("full-attention arch: 500k decode would need a dense "
                       "O(S) KV cache per layer and O(S) attention per step; "
                       "skipped per assignment (DESIGN.md §4)")
    return True, None
