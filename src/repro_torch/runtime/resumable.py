"""Resumable iterative loops: snapshot host-side iteration state.

The port's copy of ``repro.runtime.resumable``. Snapshots keep the
reference's format and keys, so a run interrupted in one package resumes
in the other.

MCL squares an operator for dozens of iterations; BC walks a BFS forward
and then back down the levels. A fault that escapes the session's
retry/degradation ladder aborts the *loop*, and without snapshots the only
recovery is from scratch — for the paper-scale runs (hours on hundreds of
nodes) that is the difference between a blip and a lost day. This module
adapts the checkpoint store's
:class:`~repro_torch.checkpoint.CheckpointManager`
(atomic tmp-dir+rename writes, keep-k GC) to the sparse apps' host-side
state, which is numpy + CSC rather than a fixed-shape parameter pytree:

  * :class:`LoopCheckpointer` — save a flat ``{name: ndarray}`` state dict
    per iteration through the manager; resume by loading the latest
    snapshot's raw arrays (``restore_checkpoint``'s shape-matching
    template restore cannot apply here — a CSC's nnz changes every
    iteration, so snapshots are self-describing instead);
  * :func:`pack_csc` / :func:`unpack_csc` (+ the ``_list`` variants) —
    round-trip CSC matrices through that flat dict losslessly (indptr /
    indices / data / shape), preserving dtypes bit-for-bit.

``apps.mcl`` and ``apps.bc`` accept ``checkpoint_dir=`` and wire
themselves through this; an interrupted run re-invoked with the same
directory resumes at the last completed iteration and converges to the
bitwise-identical result (the loops are deterministic given their state).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..checkpoint import CheckpointManager, latest_step

__all__ = ["LoopCheckpointer", "pack_csc", "unpack_csc", "pack_csc_list",
           "unpack_csc_list"]


def pack_csc(prefix: str, mat, out: Dict[str, np.ndarray]) -> None:
    """Flatten ``mat`` into ``out`` under ``prefix/...`` keys."""
    out[f"{prefix}/indptr"] = mat.indptr
    out[f"{prefix}/indices"] = mat.indices
    out[f"{prefix}/data"] = mat.data
    out[f"{prefix}/shape"] = np.asarray(mat.shape, dtype=np.int64)


def unpack_csc(prefix: str, state: Dict[str, np.ndarray]):
    from ..core.sparse import CSC
    shape = tuple(int(x) for x in state[f"{prefix}/shape"])
    return CSC(np.asarray(state[f"{prefix}/indptr"]),
               np.asarray(state[f"{prefix}/indices"]),
               np.asarray(state[f"{prefix}/data"]), shape)


def pack_csc_list(prefix: str, mats, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}/n"] = np.asarray(len(mats), dtype=np.int64)
    for i, m in enumerate(mats):
        pack_csc(f"{prefix}/{i}", m, out)


def unpack_csc_list(prefix: str, state: Dict[str, np.ndarray]) -> List:
    n = int(state[f"{prefix}/n"])
    return [unpack_csc(f"{prefix}/{i}", state) for i in range(n)]


class LoopCheckpointer:
    """Per-iteration snapshots of a flat numpy state dict.

    Saves ride the checkpoint store's :class:`CheckpointManager` (atomic
    renames, keep-last-``keep`` GC); ``async_save`` defaults off because
    iteration snapshots are small and a synchronous save makes
    "iteration i is durable once ``save`` returns" trivially true for the
    resume tests.
    """

    def __init__(self, ckpt_dir: str, *, keep: int = 3, every: int = 1,
                 async_save: bool = False):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.ckpt_dir = ckpt_dir
        self.every = every
        self.manager = CheckpointManager(ckpt_dir, keep=keep,
                                         async_save=async_save)

    def resume(self) -> Tuple[Optional[int],
                              Optional[Dict[str, np.ndarray]]]:
        """Latest snapshot as ``(step, state)``; ``(None, None)`` when the
        directory holds none (a fresh run)."""
        last = latest_step(self.ckpt_dir)
        if last is None:
            return None, None
        path = os.path.join(self.ckpt_dir, f"step_{last:08d}", "arrays.npz")
        with np.load(path) as data:
            state = {k: np.asarray(data[k]) for k in data.files}
        return last, state

    def maybe_save(self, step: int, state: Dict[str, np.ndarray]) -> bool:
        """Snapshot ``state`` when ``step`` hits the cadence."""
        if step % self.every != 0:
            return False
        self.manager.save(step, dict(state))
        self.manager.wait()
        return True
