"""Grouped expert GEMM op: ``grouped_gemm`` (forward only).

The kernel wrapper dispatches on the device (CUDA tensor: the hand-written
kernel of the dtype's and capacity's route; CPU tensor: the plain version).
Nothing is padded: the kernels predicate their edges, so the expert weights
are never copied. The reference's einsum backward comes with the training
slice.
"""

from __future__ import annotations

from . import kernel

__all__ = ["grouped_gemm"]


def grouped_gemm(x, w, rows=None):
    """x: (E, cap, d), w: (E, d, f) -> (E, cap, f) in x's dtype, the true
    grouped product over all of d. ``rows`` (int32 (E,) on x's device, or
    None for every row): each expert's live rows; the rest are zeros."""
    return kernel.moe_gemm(x, w, rows)
