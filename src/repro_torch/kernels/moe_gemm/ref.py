"""Plain PyTorch version of the grouped expert GEMM."""

from __future__ import annotations

import torch

__all__ = ["moe_gemm_ref"]


def moe_gemm_ref(x, w):
    """x: (E, cap, d), w: (E, d, f) -> (E, cap, f): the einsum in float32,
    cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
