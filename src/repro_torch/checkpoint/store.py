"""Checkpointing: atomic, keep-k, async, restore onto a device.

The port's counterpart of ``repro.checkpoint.store``, with the same on-disk
format, so a snapshot written by either package loads in the other: one
directory per step, ``step_%08d``, holding ``arrays.npz`` (the tree's
leaves, flattened) and ``meta.json`` (``step``, ``keys``, ``shapes``,
``dtypes``). A leaf's key is its path of dict keys and sequence indices
joined by ``/``, dict keys in sorted order (the order ``jax.tree_util``
flattens them in). Writes go to ``<dir>/tmp.<step>.<pid>`` and are renamed
into place — a crashed writer never corrupts the latest checkpoint (the
restart contract).

Trees are nested dicts, lists and tuples whose leaves are numpy arrays,
torch tensors or Python scalars (``None`` holds no leaf). Saving copies
each leaf to the host; :func:`restore_checkpoint` checks each leaf against
a template's shape, casts it to the template's dtype and puts it on
``device``, or on the template tensor's device.

``CheckpointManager`` adds keep-last-k GC and an async save thread (the
device step never blocks on the filesystem).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[
        Tuple[str, Any]]:
    """``(key, leaf)`` pairs of ``tree`` in ``jax.tree_util``'s order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _map(fn: Callable[[str, Any], Any], tree,
         prefix: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array that later writes to ``leaf`` cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_host(leaf) for key, leaf in _leaves(tree)}


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomic write of ``tree`` under ``ckpt_dir/step_<step>``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    arrays = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {
        "step": step,
        "keys": list(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, tree_like: Any,
                       step: Optional[int] = None,
                       device=None) -> Any:
    """Restore into the structure of ``tree_like``.

    Each leaf must have its template's shape (a mismatch raises
    ``ValueError``) and is cast to the template's dtype. A tensor template
    gets a tensor on ``device``, or on the template's own device when
    ``device`` is None; a numpy (or scalar) template gets a numpy array.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:

        def load(key: str, like):
            arr = data[key]
            shape = tuple(like.shape) if hasattr(like, "shape") else ()
            if arr.shape != shape:
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, the template {shape}")
            if isinstance(like, torch.Tensor):
                return torch.from_numpy(np.ascontiguousarray(arr)).to(
                    device=like.device if device is None else device,
                    dtype=like.dtype)
            return arr.astype(np.asarray(like).dtype)

        return _map(load, tree_like)


class CheckpointManager:
    """keep-last-k + async save."""

    def __init__(self, ckpt_dir: str, keep: int = 3,
                 async_save: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any):
        # copy to the host *before* handing to the thread, so a caller
        # that updates its tensors in place cannot change what is written
        host_tree = _map(lambda _, leaf: _to_host(leaf), tree)

        def _do():
            save_checkpoint(self.ckpt_dir, step, host_tree)
            self._gc()

        def _do_in_thread():
            try:
                _do()
            except Exception as e:  # raised again by wait()
                self._error = e

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=_do_in_thread,
                                            daemon=True)
            self._thread.start()
        else:
            _do()

    def wait(self):
        """Block until the pending async save is written; a save that
        failed in its thread raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device=None) -> Any:
        return restore_checkpoint(self.ckpt_dir, tree_like, step, device)
