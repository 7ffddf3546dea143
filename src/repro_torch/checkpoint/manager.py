"""Fault-tolerant checkpointing (counterpart of
``repro.checkpoint.manager``): atomic, async, keep-last-k, auto-resume.

  * save is write-to-temp + atomic rename, with a ``COMMIT`` marker, so a
    checkpoint is either fully present or absent: a killed writer never
    corrupts restart state;
  * the write runs on one background thread (training is not stalled by
    the disk); the copy to the host happens on the caller's thread, and
    every save first drains the write in flight;
  * ``latest_step`` / ``restore`` let a relaunched job resume from the
    newest complete checkpoint, the data cursor included (``meta.json``);
  * the layout is the reference's: ``step_<10 digits>/host0.npz`` (floats
    below 4 bytes upcast to f32: numpy has no portable bf16), ``meta.json``
    and ``COMMIT``.

Under a training mesh the checkpoint is "unsharded-logical", as the
reference's: ``gather_state`` gathers the parameters and the AdamW state
to whole tensors on every rank and rank 0 writes them, the same tree an
unsharded run writes; ``shard_state`` cuts a whole (restored) tree to the
current mesh's shards, which may be a smaller mesh than the writer's.

A tree is an ``nn.Module`` (its ``state_dict`` names), a mapping, a tuple or
list, or a tensor; keys join the path with ``/`` (``0/layers.3.attn.wq.w``,
``1/mu/embed.emb``, ``1/step``).  ``restore`` writes into the template's own
tensors, cast to each one's dtype and device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, nn.Module):
        items = tree.state_dict(keep_vars=True).items()
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _leaves(tree):
        t = leaf.detach()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        flat[key] = t.cpu().numpy()
    return flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        flat = _flatten(tree)          # the copy to the host, on this thread
        meta = {"step": int(step), **(extra or {})}
        # drain the write in flight first: two writers of one step would
        # race on the rename
        self.wait()
        if blocking:
            self._write(step, flat, meta)
        else:
            self._pending = self._pool.submit(self._write, step, flat, meta)

    def _write(self, step: int, flat: Dict[str, np.ndarray], meta: Dict):
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = f"{final}.tmp{os.getpid()}"     # unique per writer
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "host0.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        with self._lock:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

    def wait(self) -> None:
        """Block until the write in flight is on disk (its error raised)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                full = os.path.join(self.dir, name)
                if os.path.exists(os.path.join(full, "COMMIT")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, template: Any) -> Tuple[Any, Dict]:
        """Checkpoint ``step`` written into ``template``'s tensors ->
        (template, meta)."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "host0.npz")) as z:
            for key, leaf in _leaves(template):
                arr = z[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint {key}: shape {arr.shape} "
                                     f"!= template {tuple(leaf.shape)}")
                leaf.copy_(torch.from_numpy(arr))
        return template, meta


_OPT_LEAVES = ("mu", "nu", "master")


def gather_state(skeleton: nn.Module, layouts, opt_state: Dict, mesh
                 ) -> Tuple[nn.Module, Dict]:
    """(the whole model, the whole AdamW state) from this rank's training
    shards (``models.shard_for_training``), on every rank: collectives,
    so every rank calls it."""
    from repro_torch.models.transformer import gather_leaf, gather_model
    whole = {k: v if k not in _OPT_LEAVES else {
        name: gather_leaf(t, layouts[name].spec, mesh)
        for name, t in v.items()} for k, v in opt_state.items()}
    return gather_model(skeleton, layouts, mesh), whole


def shard_state(layouts, opt_state: Dict, mesh) -> Dict:
    """The whole AdamW state cut to this rank's shards under ``layouts``
    (the model's own cut is ``models.shard_for_training``)."""
    from repro_torch.dist.api import Sharding
    return {k: v if k not in _OPT_LEAVES else {
        name: Sharding(layouts[name].spec, mesh)(t)
        for name, t in v.items()} for k, v in opt_state.items()}
