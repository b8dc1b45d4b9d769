"""Plain PyTorch version of the grouped expert GEMM, and the float32
route's split-TF32 arithmetic on the CPU."""

from __future__ import annotations

import torch

__all__ = ["moe_gemm_ref", "moe_gemm_tf32_model"]


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


def moe_gemm_tf32_model(x, w, rows=None, block_k=32):
    """The ``"fp32"`` kernel's arithmetic on the CPU: x (E, cap, d), w
    (E, d, f) float32 -> (E, cap, f) float32.

    Per k-panel of ``block_k`` (the kernel's ``BK``): x and w split into
    TF32 hi and lo (:func:`..bsr_spgemm.ref.tf32_split`, the kernel's
    split), the panel's partial lo·hi + hi·lo + hi·hi (lo·lo left out), each
    product rounded to float32 (an infinity past FLT_MAX) and the products
    summed in float64, rounded to float32
    (:func:`..bsr_spgemm.ref.split_terms`); the partials added in float32 in
    panel order; a zero stored as +0. Where the largest ``|x|`` of an x
    row's panel and the largest ``|w|`` of the expert's w panel meet the
    kernels' unsplit rule (:func:`..bsr_spgemm.ref.unsplit_where`: an
    infinity, a NaN or ``|v| >= 2**127`` in either, or a float32 product of
    the two that is NaN or at least ``2**126``, where hi·hi could overflow),
    that row's panel is the float32 product of the unsplit operands instead.
    Rows ``r >= rows[e]`` are zeros. The kernel decides the unsplit panels
    for a pair of rows and a 128-column tile at a time and sums each panel's
    terms in fp32 in its own order, truncating below the accumulator's last
    place, which this model does not reproduce."""
    from ..bsr_spgemm.ref import split_terms, tf32_split, unsplit_where

    x, w = x.float(), w.float()
    e, cap, d = x.shape
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
    y = torch.zeros(e, cap, w.shape[2], dtype=torch.float32,
                    device=x.device)
    for k0 in range(0, d, block_k):
        k = slice(k0, k0 + block_k)
        part = split_terms(((xl[:, :, k], wh[:, k]), (xh[:, :, k], wl[:, k]),
                            (xh[:, :, k], wh[:, k])))
        unsplit = unsplit_where(x[:, :, k].abs().amax(-1, keepdim=True),
                                w[:, k].abs().amax((-2, -1))[:, None, None])
        if bool(unsplit.any()):
            part = torch.where(unsplit, x[:, :, k] @ w[:, k], part)
        y = part if k0 == 0 else y + part
    y = y + 0.0
    if rows is not None:
        live = rows.to(device=x.device, dtype=torch.long).clamp(0, cap)
        keep = torch.arange(cap, device=x.device)[None, :] < live[:, None]
        y = torch.where(keep[..., None], y, 0.0)
    return y
