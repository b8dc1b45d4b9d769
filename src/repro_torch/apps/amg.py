"""AMG Galerkin product RᵀAR (paper §II.C.2, §IV.B).

Left multiplication RᵀA uses the sparsity-aware 1D algorithm; the right
multiplication (RᵀA)·R offers both the 1D algorithm and the outer-product
variant (Algorithm 3) — the paper (after Ballard et al.) finds the
outer-product form better for the short-fat × tall-skinny shape, and our
benchmark reproduces that comparison.

The port's counterpart of ``repro.apps.amg``. ``backend="device"`` runs
both multiplies on the device SpGEMM ring (``core.spgemm_1d_device``: each
part's payload gather + the ``bsr_spgemm`` CUDA kernel, through one
:class:`~repro_torch.core.session.SpGEMMSession`) — the paper's §IV.B
scenario on the product engine instead of the host oracle. The
right-multiplication algorithm choice collapses to the ring's own 1D
schedule there (the outer-product variant is a host formulation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import CSC, restriction_operator, spgemm_1d, spgemm_outer_1d
from ..core.session import SpGEMMSession, as_payload_dtype

__all__ = ["galerkin_product", "GalerkinResult"]


@dataclasses.dataclass
class GalerkinResult:
    coarse: CSC                   # Rᵀ A R
    left_bytes: int               # comm volume of Rᵀ A
    right_bytes: int              # comm volume of (RᵀA) R
    left_flops: int
    right_flops: int
    right_algorithm: str


def _galerkin_device(a: CSC, r: CSC, nparts: int, bs: int,
                     nblocks: Optional[int], engine: str,
                     session=None) -> GalerkinResult:
    if session is None:
        session = SpGEMMSession()
    # AMG setup re-runs the Galerkin product with fresh values on a fixed
    # hierarchy; cast operands to the session's payload dtype up front so
    # those values-only repacks are same-dtype (the session rejects
    # silent narrowing)
    rt = as_payload_dtype(r.transpose())
    rta = session.matmul(rt, as_payload_dtype(a), nparts=nparts, bs=bs,
                         nblocks=nblocks, engine=engine)
    left = dict(session.last_call)
    coarse = session.matmul(rta, as_payload_dtype(r), nparts=nparts, bs=bs,
                            nblocks=nblocks, engine=engine)
    right = dict(session.last_call)
    return GalerkinResult(
        coarse=coarse,
        left_bytes=left["comm_bytes_planned"],
        right_bytes=right["comm_bytes_planned"],
        left_flops=left["dense_flops"],
        right_flops=right["dense_flops"],
        right_algorithm=f"device-{engine}",
    )


def galerkin_product(a: CSC, r: Optional[CSC] = None, nparts: int = 8,
                     coarsening: int = 100, nblocks: int = 2048,
                     right_algorithm: str = "outer",
                     backend: str = "host",
                     bs: int = 32,
                     engine: str = "auto",
                     session=None) -> GalerkinResult:
    """Compute RᵀAR with distributed 1D SpGEMMs.

    right_algorithm: 'outer' (Algorithm 3, the paper's choice) or '1d'.
    backend: 'host' (numpy oracle path) or 'device' (the CUDA ring via a
    persistent :class:`~repro_torch.core.session.SpGEMMSession`, created
    as ``SpGEMMSession()`` — on the card — when none is passed; ``bs`` is
    the tile side, ``engine`` selects the ring's compute engine, and
    flops/bytes are the dense-tile schedule's). Pass ``session`` to share
    the plan/executable cache across repeated Galerkin setups — AMG
    re-coarsens the same grid hierarchy, so repeated products are
    structure-keyed cache hits. On the device backend ``nparts`` counts
    the ring's logical parts on the session's one device.
    """
    if r is None:
        r = restriction_operator(a, coarsening=coarsening)

    if backend == "device":
        # element-level nblocks doesn't map to tile-column groups; the ring
        # plans its own Algorithm-2 grouping when given one (None = exact)
        return _galerkin_device(a, r, nparts, bs, None, engine,
                                session=session)
    if backend != "host":
        raise ValueError(f"backend must be 'host' or 'device', got "
                         f"{backend!r}")

    rt = r.transpose()

    left = spgemm_1d(rt, a, nparts, nblocks=nblocks)
    rta = left.concat()

    if right_algorithm == "outer":
        right = spgemm_outer_1d(rta, r, nparts)
        coarse = right.concat()
        right_bytes = right.total_bytes
        right_flops = int(right.per_process_flops.sum())
    else:
        right = spgemm_1d(rta, r, nparts, nblocks=nblocks)
        coarse = right.concat()
        right_bytes = right.plan.total_fetched_bytes
        right_flops = int(right.flops.sum())

    return GalerkinResult(
        coarse=coarse,
        left_bytes=left.plan.total_fetched_bytes,
        right_bytes=right_bytes,
        left_flops=int(left.flops.sum()),
        right_flops=right_flops,
        right_algorithm=right_algorithm,
    )
