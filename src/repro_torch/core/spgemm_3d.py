"""Split-3D-SpGEMM baseline [Azad et al. '16] — grid×grid×layers mesh.

The k dimension is split across ``layers``; each layer runs a 2D sparse
SUMMA on its k-slice of A and B, then the layers' partial C results are
merged (split along columns + reduced across layers). The paper selects the
best layer count per input; our benchmark harness sweeps layers the same
way.

The port's copy of ``repro.core.spgemm_3d``: the host oracle that the
device Split-3D (``spgemm_3d_device.py``) is held against.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .local_spgemm import spadd
from .plan import summa3d_comm_volume
from .semiring import PLUS_TIMES, Semiring
from .sparse import CSC
from .spgemm_2d import spgemm_2d

__all__ = ["SpGEMM3DResult", "spgemm_3d"]


@dataclasses.dataclass
class SpGEMM3DResult:
    c: CSC
    comm_bytes_total: int
    comm_bytes_merge: int
    messages: int
    t_compute: float


def spgemm_3d(a: CSC, b: CSC, grid: int, layers: int,
              semiring: Semiring = PLUS_TIMES) -> SpGEMM3DResult:
    assert a.ncols == b.nrows
    k = a.ncols
    ksplits = np.linspace(0, k, layers + 1).astype(np.int64)
    vol = summa3d_comm_volume(a, b, grid, layers)

    t0 = time.perf_counter()
    bt = b.transpose()
    acc: Optional[CSC] = None
    for l in range(layers):
        lo, hi = int(ksplits[l]), int(ksplits[l + 1])
        a_l = a.col_slice(lo, hi)
        b_l = bt.col_slice(lo, hi).transpose()
        part = spgemm_2d(a_l, b_l, grid, semiring).c
        acc = part if acc is None else spadd(acc, part, semiring)
    t1 = time.perf_counter()

    return SpGEMM3DResult(
        c=acc,
        comm_bytes_total=vol["total_bytes"],
        comm_bytes_merge=vol["bytes_merge"],
        messages=vol["messages"],
        t_compute=t1 - t0,
    )
