"""High-level ops for the block-sparse SpGEMM kernel.

``local_spgemm_device`` multiplies two host-side :class:`BlockSparse`
matrices on one device — the CUDA kernel for a CUDA device, the plain
version on the CPU — and returns a BlockSparse result. The schedule and
its run boundaries are host-built.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.blocksparse import (BlockSparse, ProductSchedule, build_schedule,
                                 flags_from_c_slot)
from ...core.device_common import resolve_device
from ...core.semiring import PLUS_TIMES, Semiring
from .kernel import bsr_spgemm, run_starts_from_flags

__all__ = ["schedule_flags", "local_spgemm_device"]


def schedule_flags(sched: ProductSchedule) -> np.ndarray:
    """Pack first/last-visit booleans into the kernel's i32 flag word."""
    return flags_from_c_slot(sched.c_slot)


def local_spgemm_device(a: BlockSparse, b: BlockSparse, *,
                        device="cuda",
                        semiring: Semiring = PLUS_TIMES) -> BlockSparse:
    """C = A ⊗ B on ``device`` over ``semiring``. Operand payloads must be
    identity-filled (``from_csc(..., fill=semiring.zero)``) — a mismatched
    fill is a silent-corruption hazard (e.g. 0.0-filled tiles under
    min-plus act as zero-cost edges), so it is rejected here. The result
    container carries the same fill."""
    assert a.bs == b.bs
    for name, op in (("a", a), ("b", b)):
        # float != is the right test: inf != inf is False, so an
        # inf-filled min-plus operand passes its inf-identity semiring
        if op.ntiles and op.fill != semiring.zero:
            raise ValueError(
                f"operand {name!r} payloads are filled with {op.fill!r} "
                f"but semiring {semiring.name!r} pads with its identity "
                f"{semiring.zero!r}; blockize with "
                f"from_csc(..., fill=semiring.zero)")
    dev = resolve_device(device)
    sched = build_schedule(a, b)
    bs = a.bs
    if sched.nprod == 0:
        return BlockSparse(
            tiles=semiring.fill((0, bs, bs), dtype=a.tiles.dtype),
            tile_rows=np.zeros(0, dtype=np.int32),
            tile_cols=np.zeros(0, dtype=np.int32),
            shape=(a.shape[0], b.shape[1]),
            orig_shape=(a.orig_shape[0], b.orig_shape[1]),
            bs=bs,
            fill=semiring.zero,
        )

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out = bsr_spgemm(
        put(a.tiles.astype(np.float32)), put(b.tiles.astype(np.float32)),
        put(sched.a_slot), put(sched.b_slot), put(sched.c_slot),
        put(run_starts_from_flags(schedule_flags(sched), 0, sched.nprod)),
        nprod=sched.nprod, nc=sched.nc, bs=bs, semiring=semiring)
    return BlockSparse(
        tiles=out.cpu().numpy(),
        tile_rows=sched.c_rows,
        tile_cols=sched.c_cols,
        shape=(a.shape[0], b.shape[1]),
        orig_shape=(a.orig_shape[0], b.orig_shape[1]),
        bs=bs,
        fill=semiring.zero,
    )
