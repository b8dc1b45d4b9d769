"""Plain PyTorch version of flash attention (materializes the logit matrix),
and the float32 route's split-TF32 arithmetic on the CPU."""

from __future__ import annotations

import torch

from ..bsr_spgemm.ref import split_terms, tf32_split, unsplit_where

__all__ = ["attention_ref", "attention_tf32_model", "fold_gqa", "mha_ref"]

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


def attention_tf32_model(q, k, v, *, scale: float, block_k: int,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0):
    """The ``"fp32"`` kernel's arithmetic in the model layout: q (B, S, Hq,
    D), k and v (B, S, Hkv, D) float32 -> (B, S, Hq, D) float32.

    q, k and v are split into TF32 hi and lo (``hi = rna_tf32(x)``, ``lo =
    rna_tf32(x - hi)``, :func:`..bsr_spgemm.ref.tf32_split`, the kernel's
    split) and per key block of ``block_k`` keys (the kernel's ``BK``):
    logits lo·hi + hi·lo + hi·hi (lo·lo left out), each product rounded to
    float32 (an infinity past FLT_MAX) and summed in float64, rounded to
    float32 per block (:func:`..bsr_spgemm.ref.split_terms`); where a q
    row's and the key block's largest magnitudes meet the kernels' unsplit
    rule (:func:`..bsr_spgemm.ref.unsplit_where`: an infinity, a NaN or
    ``|x| >= 2**127`` in either, or a float32 product of the two that is NaN
    or at least ``2**126``, where hi·hi could overflow), that row's logits
    are the float32 product of the unsplit q and k instead; then scale,
    softcap, mask to -1e30, the online max m and rescale exp(m_old - m_new),
    l summed from the unsplit p, then p split the same way and the block's
    PV as p_lo·v_hi + p_hi·v_lo + p_hi·v_hi (exact products summed in
    float64) added to the rescaled accumulator; divide by l (1 where it is
    0). The kernel decides the unsplit blocks for its whole tile of query
    rows, and the tensor core sums each term's products in fp32 in its own
    order and truncates below the accumulator's last place, which this
    model does not reproduce."""
    b, s, hq, d = q.shape
    qf, kf, vf = (t.float() for t in fold_gqa(q, k, v))
    (qh, ql), (kh, kl) = tf32_split(qf), tf32_split(kf)
    vh, vl = (x.double() for x in tf32_split(vf))
    q_mag = qf.abs().amax(-1, keepdim=True)
    rows = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b * hq, s, 1), NEG_INF, device=q.device)
    l = torch.zeros(b * hq, s, 1, device=q.device)
    acc = torch.zeros(b * hq, s, d, device=q.device)
    for k0 in range(0, s, block_k):
        blk = slice(k0, k0 + block_k)
        kh_t, kl_t = kh[:, blk].transpose(1, 2), kl[:, blk].transpose(1, 2)
        x = split_terms(((ql, kh_t), (qh, kl_t), (qh, kh_t)))
        unsplit = unsplit_where(
            q_mag, kf[:, blk].abs().amax((-2, -1))[:, None, None])
        if bool(unsplit.any()):
            x = torch.where(unsplit, qf @ kf[:, blk].transpose(1, 2), x)
        x = x * scale
        if softcap > 0.0:
            x = softcap * torch.tanh(x / softcap)
        cols = torch.arange(k0, k0 + x.shape[2], device=q.device)[None, :]
        mask = torch.ones(s, x.shape[2], dtype=torch.bool, device=q.device)
        if causal:
            mask &= cols <= rows
        if window > 0:
            mask &= cols > rows - window
        x = torch.where(mask, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(x - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        ph, pl = (t.double() for t in tf32_split(p))
        part = pl @ vh[:, blk] + ph @ vl[:, blk] + ph @ vh[:, blk]
        acc = acc * alpha + part.float()
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, hq, s, d).permute(0, 2, 1, 3).contiguous()
