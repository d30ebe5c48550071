"""Checkpointing of the port (``repro/checkpoint/store.py``): atomic,
integrity-checked, async-capable, on the reference's on-disk protocol, so
either package restores the other's checkpoints.

  * atomic — a checkpoint directory appears only after every array and the
    manifest are fully written (write to ``.tmp_step_*``, fsync, rename), so
    a crash mid-save never leaves a "latest" checkpoint that doesn't restore;
  * integrity-checked — ``manifest.json`` stores each array's file, shape,
    logical dtype and ``crc32``; restore verifies them and refuses a corrupt
    step;
  * the reference's keys — each array is keyed by its tree path
    (``params/units/0/attn/wq``, ``opt/mu/3/m``; :mod:`repro_torch.tree`),
    files numbered in the reference's leaf order, a unit leaf
    (:class:`~repro_torch.tree.Stack`) stacked along its leading axis on
    save and split on restore;
  * bfloat16 is stored as its ``uint16`` bit pattern with the logical dtype
    in the manifest, as the reference stores it, through
    ``Tensor.view(torch.int16)`` (no ``ml_dtypes``);
  * async — ``CheckpointManager(async_save=True)`` copies to host memory on
    the caller's thread and writes on a background thread;
  * retention — keep the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..tree import (Stack, as_array, leaves_with_paths, like, map_leaves,
                    map_with_paths, parts, path_key)


def _to_savable(leaf):
    """(numpy array as stored, logical dtype name) of a leaf."""
    t = as_array(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_savable(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _snapshot(leaf):
    """A leaf's host copy that later in-place updates cannot reach."""
    return as_array(leaf).detach().to("cpu", copy=True)


def save_checkpoint(ckpt_dir, step: int, tree) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "arrays": {}}
    for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
        arr, logical = _to_savable(leaf)
        fname = f"arr_{i:05d}.npy"
        with open(tmp / fname, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["arrays"][path_key(path)] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": logical,
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
        if (p / "manifest.json").exists()
    )
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, like_tree, step: Optional[int] = None,
                       shardings=None, verify: bool = True):
    """(a tree of ``like_tree``'s structure holding step ``step``'s arrays
    (default: the latest), that step).  Each leaf is a new tensor on the
    device of ``like_tree``'s leaf, a :class:`~repro_torch.tree.Stack` split
    per unit; ``like_tree``'s tensors are not touched.  With ``shardings``
    (a tree of :class:`~repro_torch.models.sharding.Sharding` of the same
    structure) each array is instead placed with its sharding
    (:func:`~repro_torch.models.sharding.place`: its shards on their mesh
    devices, a unit leaf stacked), the elastic re-shard; ``like_tree`` then
    only gives shapes.  Raises ``IOError`` on a checksum mismatch and
    ``ValueError`` on a shape that differs from ``like_tree``'s."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    shard_of = None
    if shardings is not None:
        from ..models.sharding import place

        shard_of = dict(leaves_with_paths(shardings))

    def load(path, leaf):
        key = path_key(path)
        meta = manifest["arrays"][key]
        arr = np.load(d / meta["file"])
        if verify:
            crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
            if crc != meta["crc32"]:
                raise IOError(f"checksum mismatch for {key} at step {step}")
        want = (len(leaf),) + tuple(leaf[0].shape) if isinstance(
            leaf, Stack) else tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint {tuple(arr.shape)}, "
                             f"expected {want}")
        t = _from_savable(arr, meta["dtype"])
        if shard_of is not None:
            return place(t, shard_of[path])
        return like(leaf, t.to(parts(leaf)[0].device))

    return map_with_paths(load, like_tree), step


class CheckpointManager:
    def __init__(self, ckpt_dir, keep: int = 3, async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def save(self, step: int, tree):
        self.wait()
        # snapshot to host memory synchronously: the next step updates the
        # parameters and the optimizer state in place
        host = map_leaves(_snapshot, tree)

        def work():
            try:
                save_checkpoint(self.dir, step, host)
                self._gc()
            except BaseException as e:  # surfaced at next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def restore_latest(self, like_tree):
        return restore_checkpoint(self.dir, like_tree)
