"""Plain PyTorch version of flash attention (materializes the logit matrix)."""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "fold_gqa", "mha_ref"]

NEG_INF = -1e30


def attention_ref(q, k, v, *, scale: float = 1.0, causal: bool = True,
                  window: int = 0, softcap: float = 0.0):
    """q, k, v: (BH, S, D); returns (BH, S, D) in q's dtype.

    Scale, then softcap, then the mask to -1e30; masked probabilities are
    0 and a row with nothing left divides by 1, as in the kernel.
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    n = q.shape[1]
    rows = torch.arange(n, device=q.device)[:, None]
    cols = torch.arange(n, device=q.device)[None, :]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask[None], p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)


def fold_gqa(q, k, v):
    """(B, S, H, D) -> (B*H, S, D) with kv heads repeated up to Hq."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if hkv != hq:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(b * hq, s, d)
    return fold(q), fold(k), fold(v)


def mha_ref(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
            softcap: float = 0.0):
    """The kernel's function in the model layout: q (B, S, Hq, D), k and v
    (B, S, Hkv, D) -> (B, S, Hq, D), through :func:`fold_gqa` and
    :func:`attention_ref`."""
    b, s, hq, d = q.shape
    out = attention_ref(*fold_gqa(q, k, v), scale=scale, causal=causal,
                        window=window, softcap=softcap)
    return out.reshape(b, hq, s, d).permute(0, 2, 1, 3).contiguous()
