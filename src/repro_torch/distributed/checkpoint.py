"""Checkpoints in the reference's on-disk layout (numpy + a json manifest),
so a checkpoint written by either package restores in the other.

* **Layout**: one ``leaf_XXXXX.npy`` a leaf and ``manifest.json`` with,
  for each leaf, its path string (``tree.key_path``'s, the reference's
  ``tree_flatten_with_path`` keys: ``params/layers/0/mixer/wq``), file,
  shape and logical dtype.  bf16 leaves are stored as fp32 (lossless)
  under the logical dtype ``bfloat16``.  ``restore`` looks leaves up by
  path, never by position (the reference's trees sort dict keys; the
  port's keep insertion order).
* **Atomicity**: writes go to ``step_XXXXXXXX.tmp``, then ``os.rename``.
* **Async**: ``AsyncCheckpointer.save_async`` copies the tree to host
  memory at once and writes it on a background thread.
* **GC**: the newest ``keep`` checkpoints stay.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_path, tree_map, \
    tree_map_with_path

_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.float16: "float16", torch.int32: "int32",
          torch.int64: "int64", torch.bool: "bool"}


class _Host:
    """A leaf copied to host memory: the array as stored, its logical
    dtype name."""

    def __init__(self, leaf):
        if isinstance(leaf, _Host):
            self.arr, self.logical = leaf.arr, leaf.logical
        elif isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            self.logical = _NAMES[t.dtype]
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            self.arr = t.numpy().copy()
        else:
            self.arr = np.asarray(leaf)
            self.logical = str(self.arr.dtype)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save.  Returns the checkpoint path.  ``tree``
    may hold tensors, numpy arrays or host copies (``_Host``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "time": time.time()}
    for i, (key, leaf) in enumerate(tree_leaves_with_path(tree)):
        host = _Host(leaf)
        arr, logical = host.arr, host.logical
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"key": key, "file": fn,
                                   "shape": list(arr.shape),
                                   "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Snapshot to host now, write to disk in the background."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save_async(self, step: int, tree, extra=None):
        self.wait()                                   # one in flight
        host_tree = tree_map(_Host, tree)             # device -> host now

        def _run():
            try:
                save(self.ckpt_dir, step, host_tree, keep=self.keep,
                     extra=extra)
            except Exception as e:                    # surfaced on wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like, *, step: Optional[int] = None
            ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf found by its path, cast to the dtype and put on the device of
    ``like``'s leaf.  Returns (tree, step, extra)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {m["key"]: m for m in manifest["leaves"]}

    def load(key, leaf):
        meta = by_key[key]
        arr = np.load(os.path.join(path, meta["file"]))
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    return (tree_map_with_path(load, like), step,
            manifest.get("extra", {}))


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
