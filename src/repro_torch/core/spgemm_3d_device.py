"""Device execution of Split-3D-SpGEMM [Azad et al. '16] — layered SUMMA.

The port's counterpart of ``repro.core.spgemm_3d_device``: the second
sparsity-*oblivious* baseline the paper compares against. The MPI original
distributes processes on a ``grid x grid x layers`` mesh: the contraction
(k) dimension is split across the ``layers`` axis, every layer runs a 2D
sparse SUMMA on its k-slice of A and B, and the layers' partial C results
are merged with an all-to-all + reduction across the layer axis.

The port reuses the device SUMMA machinery wholesale
(``spgemm_2d_device.build_summa_plan(..., layers=L)``); what this module
adds is the 3D reading of its two extra moving parts:

  * **k-split**: the contraction partition has ``grid * layers`` tile-
    aligned pieces; piece ``l*grid + s`` is stage ``s`` *of layer* ``l``.
    Each layer's stage broadcasts stay layer-local: part (r, c, l) reads
    only layer l's blocks of the flat payload stacks.

  * **cross-layer merge**: the reference's one semiring all-reduce over the
    layer mesh axis (psum / pmax / pmin) becomes ``Semiring.axis_reduce``
    over a tensor dim (sum / amax / amin), streamed layer by layer into
    each (r, c) block's accumulator. The layers' schedules all target the
    *union* of their output tiles, so the reduce is elementwise, and slots
    a layer never writes hold the additive identity — no literal ``0.0``
    anywhere.

Across processes (``mesh=``, one rank per (r, c, l)) the merge is the
reference's again: the layers' partials are gathered over the mesh's
``"gl"`` dim and each rank reduces them two at a time in layer order
(``spgemm_2d_device``), never by an ``all_reduce(MIN / MAX)``, which drops
a NaN that is not on rank 0 under gloo.

Like its host counterpart (``spgemm_3d.py``), the layer count is a tuning
knob the paper sweeps per input.
"""

from __future__ import annotations

import numpy as np

from .semiring import PLUS_TIMES, Semiring
from .sparse import CSC
from .spgemm_2d_device import (SummaDevicePlan, build_summa_plan,
                               compile_summa, decode_summa_output,
                               repack_summa_payloads, run_device_summa)

__all__ = ["build_summa3d_plan", "compile_summa3d", "run_device_summa3d",
           "decode_summa3d_output", "repack_summa3d_payloads"]


def build_summa3d_plan(a: CSC, b: CSC, grid: int, layers: int,
                       bs: int = 128, dtype=np.float32,
                       semiring: Semiring = PLUS_TIMES) -> SummaDevicePlan:
    """Plan a Split-3D SpGEMM on a (grid, grid, layers) device mesh."""
    assert layers >= 1
    return build_summa_plan(a, b, grid, layers=layers, bs=bs, dtype=dtype,
                            semiring=semiring)


# execution, decode and the values-only payload repack are identical to the
# generalized SUMMA path — the layer reduce activates whenever
# plan.layers > 1
compile_summa3d = compile_summa
run_device_summa3d = run_device_summa
decode_summa3d_output = decode_summa_output
repack_summa3d_payloads = repack_summa_payloads
