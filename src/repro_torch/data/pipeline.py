"""Deterministic, resumable synthetic data stream (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step), drawn with numpy exactly as
the reference draws it, so the two packages see bit-equal batches:
restart-safe (skip-ahead is ``state = step``), and it serves the three
input modes (tokens / embeds / enc-dec).  ``to_device`` moves a batch onto
an explicit device.  Sharding specs (``batch_specs``) come with
tensor-parallel training.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


class SyntheticLMData:
    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self._step = 0

    # ---- iterator protocol with explicit, checkpointable state ----
    def state(self) -> int:
        return self._step

    def restore(self, state: int) -> None:
        self._step = int(state)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, Any]:
        b = self.batch_at(self._step)
        self._step += 1
        return b

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        out: Dict[str, np.ndarray] = {}
        toks = rng.integers(0, cfg.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        if cfg.input_mode == "embeds":
            out["embeds"] = rng.standard_normal(
                (self.batch, self.seq, cfg.d_model)).astype(np.float32)
            out["labels"] = toks[:, 1:]
        else:
            out["tokens"] = toks[:, :-1]
            out["labels"] = toks[:, 1:]
        if cfg.family == "audio":
            out["enc_embeds"] = rng.standard_normal(
                (self.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
