"""Grouped expert GEMM op: ``grouped_gemm`` (forward only).

The kernel wrapper dispatches on the device (CUDA tensor: the hand-written
kernel; CPU tensor: the plain version). Nothing is padded: the kernel
predicates its edges, so the expert weights are never copied. The
reference's einsum backward comes with the training slice.
"""

from __future__ import annotations

from . import kernel

__all__ = ["grouped_gemm"]


def grouped_gemm(x, w):
    """x: (E, cap, d), w: (E, d, f) -> (E, cap, f) in x's dtype, the true
    grouped product over all of d."""
    return kernel.moe_gemm(x, w)
