"""Sparsity-aware 1D SpGEMM — Algorithm 1 of the paper (host execution path).

``spgemm_1d`` executes the algorithm process-by-process exactly as the MPI
version would, against the symbolic :class:`FetchPlan`:

  1. (symbolic) allgather nonzero-column metadata of A, build hit vectors
     H_i from B_i, intersect, group into block fetches        -> plan.py
  2. (numeric)  fetch the planned remote columns of A, assemble the compact
     matrix Ã, and run the local SpGEMM  C_i = Ã × B_i         -> here

C inherits B's 1D column partition with zero output communication — the
property the whole algorithm is built around.

The device execution of the same plan (the ring on one CUDA device) lives in
``spgemm_1d_device.py``; this module is the oracle it is validated against.
The port's copy of ``repro.core.spgemm_1d``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from .local_spgemm import spgemm, spgemm_flops
from .plan import BYTES_PER_NNZ, FetchPlan, Partition1D, build_fetch_plan
from .semiring import PLUS_TIMES, Semiring
from .sparse import CSC, hstack_partitions

__all__ = ["SpGEMM1DResult", "spgemm_1d", "spgemm_1d_simple"]


@dataclasses.dataclass
class SpGEMM1DResult:
    c_parts: List[CSC]           # C_i per process (global row space, local cols)
    plan: FetchPlan
    # per-process instrumentation (mirrors the paper's Fig. 4/8 breakdown)
    comm_bytes: np.ndarray       # fetched bytes received by each process
    comm_messages: np.ndarray    # RDMA-equivalent message count per process
    flops: np.ndarray            # nontrivial multiplies per process
    t_pack: np.ndarray           # "other": Ã assembly per process (s)
    t_compute: np.ndarray        # local SpGEMM per process (s)

    def concat(self) -> CSC:
        return hstack_partitions(self.c_parts)


def spgemm_1d(a: CSC, b: CSC, nparts: int,
              part_k: Optional[Partition1D] = None,
              part_n: Optional[Partition1D] = None,
              nblocks: int = 2048,
              semiring: Semiring = PLUS_TIMES,
              plan: Optional[FetchPlan] = None) -> SpGEMM1DResult:
    """Run Algorithm 1 over ``nparts`` logical processes.

    The numeric phase assembles Ã from the *required* columns (the fetched
    superset differs only in unused columns — they multiply against empty
    rows of B_i, so the products are bitwise identical; the fetched bytes
    are what the comm accounting charges, exactly like the RDMA original).
    """
    if part_k is None:
        part_k = Partition1D.balanced(a.ncols, nparts)
    if part_n is None:
        part_n = Partition1D.balanced(b.ncols, nparts)
    if plan is None:
        plan = build_fetch_plan(a, b, part_k, part_n, nblocks)

    P = nparts
    comm_bytes = plan.per_process_fetched_bytes()
    comm_msgs = plan.per_process_messages()
    flops = np.zeros(P, dtype=np.int64)
    t_pack = np.zeros(P)
    t_comp = np.zeros(P)

    # required remote + local columns per process
    required: List[List[np.ndarray]] = [[] for _ in range(P)]
    for p in plan.pairs:
        required[p.dst].append(p.required_cols)
    for i in range(P):
        required[i].append(plan.local_required[i])

    c_parts: List[CSC] = []
    for i in range(P):
        nlo, nhi = part_n.part_slice(i)
        b_i = b.col_slice(nlo, nhi)

        t0 = time.perf_counter()
        cols = np.sort(np.concatenate(required[i])) if required[i] else \
            np.zeros(0, dtype=np.int64)
        # Ã: only the participating columns, scattered back to global k ids
        a_tilde = a.select_cols(cols).scatter_cols_into(cols, a.ncols)
        t1 = time.perf_counter()
        c_i = spgemm(a_tilde, b_i, semiring)
        t2 = time.perf_counter()

        t_pack[i] = t1 - t0
        t_comp[i] = t2 - t1
        flops[i] = spgemm_flops(a_tilde, b_i)
        c_parts.append(c_i)

    return SpGEMM1DResult(
        c_parts=c_parts, plan=plan,
        comm_bytes=comm_bytes, comm_messages=comm_msgs,
        flops=flops, t_pack=t_pack, t_compute=t_comp,
    )


def spgemm_1d_simple(a: CSC, b: CSC, nparts: int,
                     nblocks: int = 2048) -> CSC:
    """Convenience wrapper returning the assembled global C."""
    return spgemm_1d(a, b, nparts, nblocks=nblocks).concat()
