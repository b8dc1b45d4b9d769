"""Flash-style chunked attention in plain torch: the attention backward.

The port's ``repro.kernels.flash_attention.chunked``: the same online-softmax
recurrence as the kernel, as a loop over key/value chunks whose body runs
under ``torch.utils.checkpoint`` (non-reentrant), as the reference's
``lax.scan`` body runs under ``jax.checkpoint``:

  * forward peak = one (S, chunk) logit tile per (batch, head);
  * the backward recomputes each chunk (flash-backward-like flops).

:func:`..ops.multihead_attention`'s backward differentiates this function
(the reference's ``_mha_bwd``): the forward pass is the kernel, the
gradient is this recurrence's, in plain torch as it is plain ``jnp`` in the
reference. Operands stay in the model layout (B, S, H, D). Numerically the
plain version's (``ref.attention_ref``: scale, softcap, mask to -1e30, a
row with nothing left divides by 1).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["attention_chunked"]

NEG_INF = -1e30


def _chunk(carry, kc, vc, k_lo: int, qf, causal: bool, window: int,
           softcap: float):
    """One key chunk of the recurrence: carry (m, l, acc) -> new carry."""
    m, l, acc = carry                      # (B,H,S), (B,H,S), (B,S,H,D)
    s, chunk = qf.shape[1], kc.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float())
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    rows = torch.arange(s, device=qf.device)[:, None]
    cols = k_lo + torch.arange(chunk, device=qf.device)[None, :]
    mask = torch.ones((s, chunk), dtype=torch.bool, device=qf.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(-1))
    p = torch.exp(logits - m_new[..., None])
    p = torch.where(mask[None, None], p, 0.0)
    alpha = torch.exp(m - m_new)           # (B,H,S)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha.permute(0, 2, 1)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, vc.float())
    return m_new, l, acc


def attention_chunked(q, k, v, *, scale: float = 1.0, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      chunk: int = 1024):
    """q, k, v: (B, S, H, D), heads already matched (GQA pre-repeated).

    Returns (B, S, H, D) in q's dtype. S must be a multiple of
    ``min(chunk, S)`` (the reference's reshape requires it; the caller
    pads); anything else raises ``ValueError``.
    """
    b, s, h, d = q.shape
    if tuple(k.shape) != (b, s, h, d) or tuple(v.shape) != (b, s, h, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match q {tuple(q.shape)}")
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of the chunk {chunk}")
    qf = q.float() * scale
    carry = (torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                        device=q.device),
             torch.zeros((b, h, s), dtype=torch.float32, device=q.device),
             torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device))
    for k_lo in range(0, s, chunk):
        kc, vc = k[:, k_lo:k_lo + chunk], v[:, k_lo:k_lo + chunk]
        carry = checkpoint(_chunk, carry, kc, vc, k_lo, qf, causal, window,
                           softcap, use_reentrant=False)
    _, l, acc = carry
    l_safe = torch.where(l == 0.0, 1.0, l).permute(0, 2, 1)  # (B,S,H)
    return (acc / l_safe[..., None]).to(q.dtype)
