"""Deterministic, resumable synthetic data stream (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step), drawn with numpy exactly as
the reference draws it, so the two packages see bit-equal batches:
restart-safe (skip-ahead is ``state = step``), and it serves the three
input modes (tokens / embeds / enc-dec).  ``to_device`` moves a batch onto
an explicit device.  ``batch_specs`` are the reference's logical specs of
a training batch; ``local_batch`` cuts a rank's rows out of the global
batch under a training mesh.
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


def batch_specs(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    """Logical sharding specs of a training batch (mirrors ``batch_at``)."""
    out: Dict[str, Any] = {}
    if cfg.input_mode == "embeds":
        out["embeds"] = ("act_batch", None, None)
    else:
        out["tokens"] = ("act_batch", None)
    out["labels"] = ("act_batch", None)
    if cfg.family == "audio":
        out["enc_embeds"] = ("act_batch", None, None)
    return out


def local_batch(batch: Dict[str, np.ndarray], accum: int = 1
                ) -> Dict[str, np.ndarray]:
    """This rank's rows of the global ``batch`` under the active mesh's
    ``act_batch`` (``dist.api.batch_axis``; the whole batch without one).
    The global batch is ``accum`` microbatches of consecutive rows, as the
    step splits it; each is cut over the batch ranks, and this rank's
    parts are concatenated in microbatch order, so the step's split of the
    local rows into ``accum`` gives this rank's part of each global
    microbatch.  A microbatch that does not divide over the ranks raises
    (the launcher clamps ``accum`` so that it does)."""
    from repro_torch.dist.api import batch_axis
    group = batch_axis()
    if group is None:
        return batch
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % accum or (rows // accum) % group.size:
            raise ValueError(
                f"{k}: {rows} rows in {accum} microbatches do not divide "
                f"over {group.size} batch ranks")
        part = rows // accum // group.size
        mbs = v.reshape(accum, rows // accum, *v.shape[1:])
        mine = mbs[:, group.rank * part:(group.rank + 1) * part]
        out[k] = np.ascontiguousarray(
            mine.reshape(accum * part, *v.shape[1:]))
    return out


def accum_for_mesh(accum: int, batch: int, ranks: int) -> int:
    """The reference launcher's clamp: the largest accumulation depth up
    to ``accum`` whose microbatch still covers the ``ranks`` batch ranks
    (a microbatch smaller than the data axis would idle part of the
    mesh)."""
    for a in range(max(min(accum, batch // max(ranks, 1)), 1), 0, -1):
        if batch % a == 0 and (batch // a) % ranks == 0:
            return a
    raise ValueError(f"batch {batch} does not divide over {ranks} batch "
                     f"ranks")
