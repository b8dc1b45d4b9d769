"""Grouped expert GEMM op: ``grouped_gemm``, differentiable.

Forward: the kernel wrapper, which dispatches on the device (CUDA tensor:
the hand-written kernel of the dtype's and capacity's route; CPU tensor:
the plain version). Nothing is padded: the kernels predicate their edges,
so the expert weights are never copied.

Backward: the reference's (``repro.kernels.moe_gemm.ops``): two float32
einsums, ``dx = g·wᵀ`` and ``dw = xᵀ·g``, cast to x's and w's dtypes — plain
products that the reference, too, computes outside its kernel. Rows at or
past ``rows[e]`` are zeros in the forward, so their gradient is zeroed
before both products: dx is zero there and they add nothing to dw, which
makes the gradient the forward's own (in the model those rows of x are
zeros and their incoming gradient is zero, so nothing changes there).
"""

from __future__ import annotations

import torch

from . import kernel

__all__ = ["grouped_gemm"]


class _GroupedGemm(torch.autograd.Function):
    """Kernel forward, float32 einsum backward."""

    @staticmethod
    def forward(ctx, x, w, rows):
        ctx.save_for_backward(x, w, rows)
        return kernel.moe_gemm(x, w, rows)

    @staticmethod
    def backward(ctx, g):
        x, w, rows = ctx.saved_tensors
        gf = g.float()
        if rows is not None:
            cap = x.shape[1]
            live = rows.to(device=x.device, dtype=torch.long).clamp(0, cap)
            keep = torch.arange(cap, device=x.device)[None, :] < live[:, None]
            gf = torch.where(keep[..., None], gf, 0.0)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum("ecf,edf->ecd", gf, w.float()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("ecd,ecf->edf", x.float(), gf).to(w.dtype)
        return dx, dw, None


def grouped_gemm(x, w, rows=None):
    """x: (E, cap, d), w: (E, d, f) -> (E, cap, f) in x's dtype, the true
    grouped product over all of d. ``rows`` (int32 (E,) on x's device, or
    None for every row): each expert's live rows; the rest are zeros.
    Differentiable in x and w."""
    return _GroupedGemm.apply(x, w, rows)
