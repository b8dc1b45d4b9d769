"""Plain PyTorch version of the grouped expert GEMM."""

from __future__ import annotations

import torch

__all__ = ["moe_gemm_ref"]


def moe_gemm_ref(x, w, rows=None):
    """x: (E, cap, d), w: (E, d, f) -> (E, cap, f): the einsum in float32,
    cast to x's dtype. ``rows`` (int (E,) or None): rows ``r >= rows[e]``
    (clamped to ``[0, cap]``) of each expert's output are zeros."""
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    if rows is not None:
        cap = x.shape[1]
        live = rows.to(device=x.device, dtype=torch.long).clamp(0, cap)
        keep = torch.arange(cap, device=x.device)[None, :] < live[:, None]
        y = torch.where(keep[..., None], y, 0.0)
    return y.to(x.dtype)
