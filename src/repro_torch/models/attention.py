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

Under tensor parallelism (``tensor_parallel.tp_group``: the ``default``,
``serve_tp`` and ``ep_sharded`` profiles) ``wq`` / ``wk`` / ``wv`` are
this rank's columns and ``wo`` its rows: ``x`` enters through
``tp_copy``, each rank attends with its query heads (the flash kernel at
``(B, S, H/P, D)``) against the kv heads they read, and ``wo``'s parts are
summed (``tensor_parallel.row_parallel``). Where the line does not divide the heads but divides
their columns (qwen3-8b's smoke config: one kv head of 16 columns at
P = 4), the columns are gathered (``all_gather_cat``), so qk-norm and
rope see whole heads. A cache the rules split by sequence
(``init_kv_cache(seq_parts=P)``, ``launch.specs.cache_pspecs``) holds a
rank's block of positions for every kv head: the prefill moves k and v
from a split by heads to a split by sequence (one all-to-all), and a
decode step appends the token at the rank that owns its position, gathers
the query's heads, computes each rank's partial softmax (its max, sum of
exponentials and weighted values over its live positions) and combines
them over the line (flash decoding's log-sum-exp combine, one gather),
then takes the rank's heads for ``wo``'s rows.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.collectives import all_gather_cat, tp_copy
from ..kernels.flash_attention import multihead_attention
from .layers import dense_init, rmsnorm, rmsnorm_init, rope, softcap
from .tensor_parallel import TP, row_parallel, tp_group

__all__ = ["attn_init", "attn_train", "attn_prefill", "attn_decode", "KVCache",
           "init_kv_cache"]


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max / seq_parts, Hkv, hd), in place
    v: torch.Tensor
    length: int           # tokens currently valid
    seq_parts: int = 1    # ranks of the tp line the positions split over


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


def _tp_qkv(params, cfg: ModelConfig, x, positions, tp: TP):
    """:func:`_project_qkv` under tensor parallelism: ``(q, k, v, q0,
    k0)``, q of the query heads ``[q0, q0 + nq)`` this rank attends with
    (every head where the line does not divide them), k and v of the kv
    heads ``[k0, k0 + nk)`` (every kv head where the line does not divide
    them). The norms' scales go through ``tp_copy``: each rank's gradient
    there is its heads' part. The line divides the projections' columns
    (``sharding.check_executable``)."""
    hd = cfg.hd
    b, s, _ = x.shape
    xin = tp_copy(x, tp.comm, tp.dims)
    out, first = [], []
    for w, n in ((params["wq"], cfg.n_heads), (params["wk"], cfg.n_kv_heads),
                 (params["wv"], cfg.n_kv_heads)):
        y = xin @ w
        if tp.splits(n):
            first.append(tp.index * (n // tp.size))
        else:
            y = all_gather_cat(y, tp.comm, tp.dims, "tp", dim=2)
            first.append(0)
        out.append(y.reshape(b, s, -1, hd))
    q, k, v = out
    if cfg.qk_norm:
        scale = lambda name: {"scale": tp_copy(params[name]["scale"],
                                               tp.comm, tp.dims)}
        q = rmsnorm(scale("qnorm"), q, cfg.norm_eps)
        k = rmsnorm(scale("knorm"), k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v, first[0], first[1]


def _kv_heads(cfg: ModelConfig, q0: int, nq: int, k0: int):
    """The slice of a k whose first kv head is ``k0`` that query heads
    ``[q0, q0 + nq)`` read, each kv head read by as many of them, in
    order (the grouped GQA the kernel and the decode einsum take)."""
    rep = cfg.n_heads // cfg.n_kv_heads
    need = [(q0 + i) // rep for i in range(nq)]
    per = nq // (need[-1] - need[0] + 1)
    if need != [need[0] + i // per for i in range(nq)]:
        raise NotImplementedError(
            f"{cfg.name}: query heads [{q0}, {q0 + nq}) read their kv heads "
            "unevenly")
    return slice(need[0] - k0, need[-1] + 1 - k0)


def _out_cols(out, cfg: ModelConfig, tp: TP):
    """(B, S, H_rank * hd) of this rank's heads, from its heads' or every
    head's attention output: the rows of ``wo`` this rank holds."""
    b, s = out.shape[:2]
    out = out.reshape(b, s, -1)
    n = cfg.n_heads * cfg.hd // tp.size
    return out if out.shape[2] == n else out.narrow(2, tp.index * n, n)


def _attend_tp(params, cfg: ModelConfig, x, window: int, tp: TP):
    """Causal attention of this rank's heads: ``(y, k, v, k0)``, y summed
    over the line, k and v (B, S, nk, hd) for the cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v, q0, k0 = _tp_qkv(params, cfg, x, positions, tp)
    heads = _kv_heads(cfg, q0, q.shape[2], k0)
    out = multihead_attention(q.contiguous(), k[:, :, heads].contiguous(),
                              v[:, :, heads].contiguous(), cfg.hd ** -0.5,
                              True, window, cfg.attn_softcap)
    return row_parallel(_out_cols(out, cfg, tp), params["wo"], tp), k, v, k0


def attn_train(params, cfg: ModelConfig, x, *, window: int = 0):
    """x: (B, S, d) -> (B, S, d); full causal self-attention, differentiable.
    q, k and v come out of ``_project_qkv`` contiguous (a reshape of a
    product, a norm, ``torch.cat``), as the kernel takes them."""
    tp = tp_group()
    if tp is not None:
        return _attend_tp(params, cfg, x, window, tp)[0]
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = multihead_attention(q, k, v, cfg.hd ** -0.5, True, window,
                              cfg.attn_softcap)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ params["wo"]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  dtype=torch.bfloat16, seq_parts: int = 1) -> KVCache:
    """Zeros for ``max_len`` positions; with ``seq_parts`` P, this rank's
    block of ``max_len / P`` of them (``max_len`` a multiple of P)."""
    if max_len % seq_parts:
        raise ValueError(f"{seq_parts} parts do not divide a cache of "
                         f"{max_len} positions")
    shape = (batch, max_len // seq_parts, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0, seq_parts=seq_parts)


def _whole_heads(t, tp: TP):
    """(2, B, S, nk, hd) k and v of this rank's kv heads -> every rank's,
    joined along the heads in member order (no gradient)."""
    g = tp.comm.gather(t, tp.dims, "sp")               # (P, 2, B, S, nk, hd)
    return g.permute(1, 2, 3, 0, 4, 5).reshape(
        t.shape[:3] + (-1, t.shape[4]))


def _write_prompt(cfg: ModelConfig, cache: KVCache, k, v, tp: TP) -> None:
    """Positions [0, S) of the cache from k and v (B, S, nk, hd) of this
    rank's kv heads (every kv head when nk = n_kv_heads): whole, or this
    rank's block of positions, each rank's heads of it moved by one
    all-to-all."""
    s, nk = k.shape[1], k.shape[2]
    kv = torch.stack([k, v]).to(cache.k.dtype)         # (2, B, S, nk, hd)
    if cache.seq_parts == 1:
        if nk < cfg.n_kv_heads:
            kv = _whole_heads(kv, tp)
        cache.k[:, :s] = kv[0]
        cache.v[:, :s] = kv[1]
        return
    span = cache.k.shape[1]
    count = [max(0, min(span, s - j * span)) for j in range(tp.size)]
    mine, lo = count[tp.index], tp.index * span
    if nk == cfg.n_kv_heads:
        block = kv[:, :, lo:lo + mine]
    else:
        got = tp.comm.exchange(
            [kv[:, :, j * span:j * span + count[j]] for j in range(tp.size)],
            tp.dims, "sp",
            [(2, kv.shape[1], mine, nk, kv.shape[4])] * tp.size)
        block = torch.cat(got, dim=3)
    cache.k[:, :mine] = block[0]
    cache.v[:, :mine] = block[1]


def attn_prefill(params, cfg: ModelConfig, x, cache: KVCache, *,
                 window: int = 0) -> Tuple[torch.Tensor, KVCache]:
    """x: (B, S, d) -> (B, S, d); writes positions [0, S) of the cache."""
    b, s, _ = x.shape
    if s > cache.k.shape[1] * cache.seq_parts:
        raise ValueError(f"prefill of {s} tokens does not fit a cache of "
                         f"{cache.k.shape[1] * cache.seq_parts}")
    tp = tp_group()
    if tp is not None:
        out, k, v, _ = _attend_tp(params, cfg, x, window, tp)
        _write_prompt(cfg, cache, k, v, tp)
        return out, cache._replace(length=s)
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = multihead_attention(q, k, v, cfg.hd ** -0.5, True, window,
                              cfg.attn_softcap)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd) @ params["wo"]
    cache.k[:, :s] = k
    cache.v[:, :s] = v
    return out, cache._replace(length=s)


def attn_decode(params, cfg: ModelConfig, x, cache: KVCache, *,
                window: int = 0) -> Tuple[torch.Tensor, KVCache]:
    """x: (B, 1, d) one new token at position ``cache.length``.

    The softmax runs over the cache's valid prefix (and, with a window, its
    last ``window`` positions): the reference masks the rest to -1e30, whose
    exp is exactly 0, so the result is the same.
    """
    b = x.shape[0]
    pos = cache.length
    if pos >= cache.k.shape[1] * cache.seq_parts:
        raise ValueError(f"decode at position {pos} is past the cache's "
                         f"{cache.k.shape[1] * cache.seq_parts} positions")
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    tp = tp_group()
    if tp is not None:
        return _decode_tp(params, cfg, x, cache, window, positions, tp)
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
    return out @ params["wo"], cache._replace(length=pos + 1)


def sp_attend(q, k, v, lo: int, hi: int, cfg: ModelConfig, tp: TP):
    """One query token's attention over a cache split by sequence: q (B, H,
    hd) every query head, k and v (B, n, Hkv, hd) this rank's block of
    positions, of which ``[lo, hi)`` are live (the window and the length
    applied). Each rank's partial softmax (:func:`sp_part`), the parts
    gathered over the line (``all_gather_cat``: each rank's gradient is
    the sum of what every rank's heads ask of its part) and combined
    (:func:`sp_combine`): (B, H, hd) float32, every head, on every
    rank."""
    part = sp_part(q, k, v, lo, hi, cfg)
    return sp_combine(all_gather_cat(part[None], tp.comm, tp.dims, "sp"),
                      q.shape)


def sp_part(q, k, v, lo: int, hi: int, cfg: ModelConfig):
    """(B, Hkv, rep, hd + 2): the weighted values, the sum of exponentials
    and the max (detached: the result does not depend on it) of q's
    softmax over positions ``[lo, hi)`` of k and v; no position: zeros
    and a max of -inf."""
    b, h, hd = q.shape
    qg = q.reshape(b, cfg.n_kv_heads, -1, hd).float()
    if hi <= lo:
        part = torch.zeros(qg.shape[:3] + (hd + 2,), dtype=torch.float32,
                           device=q.device)
        part[..., hd + 1] = float("-inf")
        return part
    logits = torch.einsum("bkrd,bskd->bkrs", qg, k[:, lo:hi].float()) \
        * (cfg.hd ** -0.5)
    logits = softcap(logits, cfg.attn_softcap)
    m = torch.amax(logits, dim=-1).detach()
    p = torch.exp(logits - m[..., None])
    o = torch.einsum("bkrs,bskd->bkrd", p, v[:, lo:hi].float())
    return torch.cat([o, p.sum(-1)[..., None], m[..., None]], dim=-1)


def sp_combine(every, shape):
    """The log-sum-exp combine of the line's parts ``every`` (P, B, Hkv,
    rep, hd + 2), in member order: (B, H, hd) float32."""
    hd = every.shape[-1] - 2
    m = every[..., hd + 1]
    w = torch.exp(m - torch.amax(m, dim=0))          # 0 where nothing lives
    o = (every[..., :hd] * w[..., None]).sum(0)
    total = (every[..., hd] * w).sum(0)
    return (o / total[..., None]).reshape(shape)


def _decode_tp(params, cfg: ModelConfig, x, cache: KVCache, window: int,
               positions, tp: TP):
    """:func:`attn_decode` under tensor parallelism: k and v of the new
    token gathered to every kv head where the line holds them split, and
    the query's heads where the cache is split by sequence (one gather);
    the token written where its position lives; the rank's heads'
    attention over the whole cache, or :func:`sp_attend` over the rank's
    block of positions."""
    b = x.shape[0]
    pos, parts, hd = cache.length, cache.seq_parts, cfg.hd
    q, k, v, q0, k0 = _tp_qkv(params, cfg, x, positions, tp)
    nq, nk = q.shape[2], k.shape[2]
    gather_kv = nk < cfg.n_kv_heads
    gather_q = parts > 1 and nq < cfg.n_heads
    if gather_kv or gather_q:
        flat = [t.reshape(b, -1) for t, on in ((k, gather_kv), (v, gather_kv),
                                               (q, gather_q)) if on]
        sizes = [t.shape[1] for t in flat]
        g = all_gather_cat(torch.cat(flat, dim=1)[None], tp.comm, tp.dims,
                           "sp")                       # (P, B, n)
        pieces = iter(g.split(sizes, dim=2))
        whole = lambda t: next(pieces).reshape(tp.size, b, -1, hd) \
            .transpose(0, 1).reshape(b, 1, -1, hd)
        if gather_kv:
            k, v = whole(k), whole(v)
            k0 = 0
        if gather_q:
            q, q0 = whole(q), 0
    span = cache.k.shape[1]
    lo = max(0, pos - window + 1) if window > 0 else 0
    if parts == 1:
        cache.k[:, pos] = k[:, 0]
        cache.v[:, pos] = v[:, 0]
        heads = _kv_heads(cfg, q0, q.shape[2], 0)
        k_live = cache.k[:, lo:pos + 1, heads].float()
        v_live = cache.v[:, lo:pos + 1, heads].float()
        qg = q.reshape(b, 1, k_live.shape[2], -1, hd).float()
        logits = torch.einsum("bqkrd,bskd->bkrqs", qg, k_live) * (hd ** -0.5)
        probs = torch.softmax(softcap(logits, cfg.attn_softcap), dim=-1)
        out = torch.einsum("bkrqs,bskd->bqkrd", probs, v_live)
    else:
        base = tp.index * span
        if base <= pos < base + span:
            cache.k[:, pos - base] = k[:, 0]
            cache.v[:, pos - base] = v[:, 0]
        out = sp_attend(q[:, 0], cache.k, cache.v,
                        min(max(lo - base, 0), span),
                        min(max(pos + 1 - base, 0), span), cfg, tp)
    out = _out_cols(out.to(x.dtype).reshape(b, 1, -1), cfg, tp)
    return row_parallel(out, params["wo"], tp), cache._replace(length=pos + 1)
