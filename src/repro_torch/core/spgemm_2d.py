"""Sparse 2D SUMMA baseline [Buluc & Gilbert '08] — the algorithm the paper
compares against (CombBLAS's default).

Processes sit on a grid×grid mesh; A and B are block-distributed. Stage s
broadcasts A's block-column s along process rows and B's block-row s along
process columns; every process multiplies and accumulates into its local
C block. Sparsity-*oblivious*: the broadcasts move whole blocks regardless
of whether the receiver needs them, which is exactly the communication the
1D algorithm avoids.

Includes optional random symmetric permutation (the load-balancing step the
paper's 2D/3D baselines require) with its cost accounted separately, as the
paper reports both with- and without-permutation numbers.

The port's copy of ``repro.core.spgemm_2d``: the host oracle that the
device SUMMA (``spgemm_2d_device.py``) is held against.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from .local_spgemm import spadd, spgemm, spgemm_flops
from .plan import summa2d_comm_volume
from .semiring import PLUS_TIMES, Semiring
from .sparse import CSC, from_coo

__all__ = ["SpGEMM2DResult", "spgemm_2d"]


@dataclasses.dataclass
class SpGEMM2DResult:
    c: CSC
    comm_bytes_total: int
    per_process_bytes: np.ndarray
    messages: int
    per_process_flops: np.ndarray
    t_compute: float


def _block(mat: CSC, rlo: int, rhi: int, clo: int, chi: int) -> CSC:
    sub = mat.col_slice(clo, chi)
    rows, cols, vals = sub.to_coo()
    keep = (rows >= rlo) & (rows < rhi)
    return from_coo(rows[keep] - rlo, cols[keep], vals[keep],
                    (rhi - rlo, chi - clo))


def spgemm_2d(a: CSC, b: CSC, grid: int,
              semiring: Semiring = PLUS_TIMES) -> SpGEMM2DResult:
    """Execute sparse SUMMA on a simulated grid×grid mesh."""
    assert a.ncols == b.nrows
    m, k, n = a.nrows, a.ncols, b.ncols
    rs_a = np.linspace(0, m, grid + 1).astype(np.int64)
    cs_a = np.linspace(0, k, grid + 1).astype(np.int64)
    cs_b = np.linspace(0, n, grid + 1).astype(np.int64)

    vol = summa2d_comm_volume(a, b, grid)
    flops = np.zeros(grid * grid, dtype=np.int64)

    t0 = time.perf_counter()
    # C blocks accumulated per process (r, c)
    c_blocks: List[List[Optional[CSC]]] = [
        [None] * grid for _ in range(grid)]
    for s in range(grid):                      # SUMMA stages
        a_col = [_block(a, int(rs_a[r]), int(rs_a[r + 1]),
                        int(cs_a[s]), int(cs_a[s + 1])) for r in range(grid)]
        b_row = [_block(b, int(cs_a[s]), int(cs_a[s + 1]),
                        int(cs_b[c]), int(cs_b[c + 1])) for c in range(grid)]
        for r in range(grid):
            for c in range(grid):
                contrib = spgemm(a_col[r], b_row[c], semiring)
                flops[r * grid + c] += spgemm_flops(a_col[r], b_row[c])
                cur = c_blocks[r][c]
                c_blocks[r][c] = contrib if cur is None else \
                    spadd(cur, contrib, semiring)
    t1 = time.perf_counter()

    # assemble the global C (block layout -> COO -> CSC)
    rows_all, cols_all, vals_all = [], [], []
    for r in range(grid):
        for c in range(grid):
            blk = c_blocks[r][c]
            if blk is None or blk.nnz == 0:
                continue
            br, bc, bv = blk.to_coo()
            rows_all.append(br + int(rs_a[r]))
            cols_all.append(bc + int(cs_b[c]))
            vals_all.append(bv)
    if rows_all:
        c_mat = from_coo(np.concatenate(rows_all), np.concatenate(cols_all),
                         np.concatenate(vals_all), (m, n))
    else:
        c_mat = from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                         np.zeros(0), (m, n))

    return SpGEMM2DResult(
        c=c_mat,
        comm_bytes_total=vol["total_bytes"],
        per_process_bytes=vol["per_process_bytes"],
        messages=vol["messages"],
        per_process_flops=flops,
        t_compute=t1 - t0,
    )
