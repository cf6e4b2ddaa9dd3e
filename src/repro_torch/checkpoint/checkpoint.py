"""Fault-tolerant checkpointing: atomic, versioned, keep-N, async (the JAX
package's ``checkpoint/checkpoint.py``).

Layout:  <dir>/step_<N>/{manifest.json, arrays.npz}
Writes go to a tmp dir + os.replace (atomic on POSIX), so a crash mid-save
never corrupts the latest checkpoint; restore skips incomplete steps.

The arrays are the tree's leaves in ``jax.tree.flatten`` order: dict keys
sorted, a dataclass's fields in declaration order (``TrainState``: params,
opt, step; inside ``opt`` the keys m, step, v), ``None`` holding none; bf16
leaves are stored as float32.  So a checkpoint written by either package
restores into the other.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._tree import leaves, rebuild

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"


def _host(x) -> np.ndarray:
    """A copy of a leaf as a numpy array; bf16 (which npz cannot store) as
    float32, losslessly (restore casts back to the target tree's dtype).
    Always a copy: ``.numpy()`` of a CPU tensor shares its memory, and the
    train step updates parameters and moments in place while an async save
    writes."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        elif x.device.type == "cpu":
            x = x.clone()
        return x.cpu().numpy()
    return np.array(x)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    return _write(directory, step, [_host(x) for x in leaves(tree)], extra)


def _write(directory: str, step: int, arrays: List[np.ndarray],
           extra: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    keys = [f"a{i}" for i in range(len(arrays))]
    np.savez(os.path.join(tmp, ARRAYS), **dict(zip(keys, arrays)))
    manifest = {"step": step, "n_arrays": len(arrays), "extra": extra or {},
                "complete": True}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            path = os.path.join(directory, name, MANIFEST)
            try:
                with open(path) as f:
                    m = json.load(f)
                if m.get("complete"):
                    steps.append(int(name[5:]))
            except (OSError, ValueError, json.JSONDecodeError):
                continue  # skip corrupt/partial checkpoints
    return max(steps) if steps else None


def _like(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    dtype = like.dtype if hasattr(like, "dtype") else arr.dtype
    return np.asarray(arr).astype(dtype, copy=False)


def restore_checkpoint(directory: str, like_tree, step: Optional[int] = None
                       ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``like_tree`` (tensor leaves come back
    as tensors of the like leaf's dtype and device); returns (tree, step,
    extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    like = leaves(like_tree)
    if manifest["n_arrays"] != len(like):
        raise ValueError(f"checkpoint has {manifest['n_arrays']} arrays, "
                         f"tree expects {len(like)}")
    with np.load(os.path.join(path, ARRAYS)) as data:
        restored = [_like(data[f"a{i}"], x) for i, x in enumerate(like)]
    return rebuild(like_tree, restored), step, manifest.get("extra", {})


class CheckpointManager:
    """keep-N policy + async (background thread) saving."""

    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep_n = keep_n
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending: Optional[concurrent.futures.Future] = None
        self._lock = threading.Lock()

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        # copy to the host now (the train step updates tensors in place),
        # write possibly in the background
        arrays = [_host(x) for x in leaves(tree)]

        def work():
            _write(self.directory, step, arrays, extra)
            self._gc()

        if self._pool is not None:
            self.wait()
            with self._lock:
                self._pending = self._pool.submit(work)
        else:
            work()

    def wait(self) -> None:
        with self._lock:
            pending = self._pending
            self._pending = None
        if pending is not None:
            pending.result()

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like_tree):
        self.wait()
        return restore_checkpoint(self.directory, like_tree)
