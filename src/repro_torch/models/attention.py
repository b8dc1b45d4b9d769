"""Attention layer: GQA projections, RoPE, qk-norm, flash kernel, KV cache.

The port of ``repro.models.attention``; one parameter set, three paths:

  * ``attn_train``   — full-sequence causal attention through
    ``multihead_attention`` (the kernel forward, the plain chunked
    recompute backward), differentiable.
  * ``attn_prefill`` — the same attention through
    ``multihead_attention`` (the hand-written CUDA kernel on a card, the
    plain version on the CPU), and the populated KV cache.
  * ``attn_decode``  — one query token against the cache in plain torch, as
    in the reference (which has no kernel there), with the reference's
    grouped-GQA contraction: q reshaped to (B, 1, Hkv, rep, hd) against the
    (B, S, Hkv, hd) cache, so the cache is read once at kv-head width.

The KV cache is bf16 and is written in place: prefill and decode return a
:class:`KVCache` holding the same k/v tensors with the new length.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import multihead_attention
from .layers import dense_init, rmsnorm, rmsnorm_init, rope, softcap

__all__ = ["attn_init", "attn_train", "attn_prefill", "attn_decode", "KVCache",
           "init_kv_cache"]


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, Hkv, hd), written in place
    v: torch.Tensor
    length: int           # tokens currently valid


def attn_init(generator, cfg: ModelConfig, *, device, dtype):
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    kw = dict(device=device, dtype=dtype)
    p = {
        "wq": dense_init(generator, d, nq, **kw),
        "wk": dense_init(generator, d, nkv, **kw),
        "wv": dense_init(generator, d, nkv, **kw),
        "wo": dense_init(generator, nq, d, **kw),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(hd, **kw)
        p["knorm"] = rmsnorm_init(hd, **kw)
    return p


def _project_qkv(params, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(params["knorm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(params, cfg: ModelConfig, x, *, window: int = 0):
    """x: (B, S, d) -> (B, S, d); full causal self-attention, differentiable.
    q, k and v come out of ``_project_qkv`` contiguous (a reshape of a
    product, a norm, ``torch.cat``), as the kernel takes them."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = multihead_attention(q, k, v, cfg.hd ** -0.5, True, window,
                              cfg.attn_softcap)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ params["wo"]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  dtype=torch.bfloat16) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def attn_prefill(params, cfg: ModelConfig, x, cache: KVCache, *,
                 window: int = 0) -> Tuple[torch.Tensor, KVCache]:
    """x: (B, S, d) -> (B, S, d); writes positions [0, S) of the cache."""
    b, s, _ = x.shape
    if s > cache.k.shape[1]:
        raise ValueError(f"prefill of {s} tokens does not fit a cache of "
                         f"{cache.k.shape[1]}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = multihead_attention(q, k, v, cfg.hd ** -0.5, True, window,
                              cfg.attn_softcap)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd) @ params["wo"]
    cache.k[:, :s] = k
    cache.v[:, :s] = v
    return out, KVCache(cache.k, cache.v, s)


def attn_decode(params, cfg: ModelConfig, x, cache: KVCache, *,
                window: int = 0) -> Tuple[torch.Tensor, KVCache]:
    """x: (B, 1, d) one new token at position ``cache.length``.

    The softmax runs over the cache's valid prefix (and, with a window, its
    last ``window`` positions): the reference masks the rest to -1e30, whose
    exp is exactly 0, so the result is the same.
    """
    b = x.shape[0]
    pos = cache.length
    if pos >= cache.k.shape[1]:
        raise ValueError(f"decode at position {pos} is past the cache's "
                         f"{cache.k.shape[1]} positions")
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    cache.k[:, pos] = k[:, 0]
    cache.v[:, pos] = v[:, 0]
    lo = max(0, pos - window + 1) if window > 0 else 0
    k_live = cache.k[:, lo:pos + 1].float()
    v_live = cache.v[:, lo:pos + 1].float()

    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, 1, cfg.n_kv_heads, rep, cfg.hd).float()
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg, k_live) * (cfg.hd ** -0.5)
    logits = softcap(logits, cfg.attn_softcap)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v_live)
    out = out.to(x.dtype).reshape(b, 1, cfg.n_heads * cfg.hd)
    return out @ params["wo"], KVCache(cache.k, cache.v, pos + 1)
