"""The LM: embedding → layer stack → final norm → (tied) logits.

The serving entry points of ``repro.models.transformer``:

  * :func:`prefill_step` — last-position logits + populated caches
  * :func:`decode_step`  — one token per sequence against the caches

The reference stacks each pattern position's parameters over periods and
scans them; here the stack is a plain list of per-layer dicts run in a
Python loop (layer ``l`` has kind ``cfg.pattern[l % len(cfg.pattern)]``),
on one card in one process, so the reference's sharding annotations have
no counterpart. ``loss_fn``, ``train_logits`` and the chunked cross
entropy come with the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..configs.base import ModelConfig
from ..core.device_common import resolve_device
from .blocks import block_apply, block_cache_init, block_init
from .layers import compute_dtype, rmsnorm, rmsnorm_init, softcap, \
    trunc_normal

__all__ = ["init_params", "init_caches", "prefill_step", "decode_step",
           "layer_kinds"]


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every layer, in order."""
    return [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype: torch.dtype = torch.bfloat16):
    """Random weights: ``{"embed", "final_norm", "layers": [...]}``.

    Every tensor is drawn in float32 from ``generator`` (a
    ``torch.Generator`` on ``device``; a fresh one seeded 0 when None) and
    cast to ``dtype`` before the next is drawn, so the full float32 model
    is never held.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(device=dev, dtype=dtype)
    embed = trunc_normal(generator, (cfg.vocab, cfg.d_model),
                         cfg.d_model ** -0.5, **kw)
    layers = [block_init(generator, cfg, kind, **kw)
              for kind in layer_kinds(cfg)]
    return {"embed": embed,
            "final_norm": rmsnorm_init(cfg.d_model, **kw),
            "layers": layers}


def _embed_input(params, cfg: ModelConfig, batch):
    if cfg.input_kind == "embeds":
        h = batch["embeds"]
    else:
        h = params["embed"][batch["tokens"]]
    return h.to(compute_dtype(cfg.dtype))


def _as_compute(tree, dtype):
    """float32 weights cast to the compute dtype (mixed precision, as the
    reference casts its float32 master); other dtypes as they are."""
    if isinstance(tree, dict):
        return {k: _as_compute(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def _run_stack(params, cfg: ModelConfig, h, mode: str, caches):
    dtype = compute_dtype(cfg.dtype)
    new_caches = []
    for kind, lp, cache in zip(layer_kinds(cfg), params["layers"], caches):
        h, nc, _ = block_apply(_as_compute(lp, dtype), cfg, kind, h, cache,
                               mode)
        new_caches.append(nc)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), new_caches


def _logits(params, cfg: ModelConfig, h):
    """Last-position logits in float32 against the tied embedding."""
    logits = h[:, -1].float() @ params["embed"].float().T
    return softcap(logits, cfg.logit_softcap)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda", dtype: torch.dtype = torch.bfloat16
                ) -> List[Any]:
    """One cache per layer (a bf16 KV cache for attention kinds)."""
    dev = resolve_device(device)
    return [block_cache_init(cfg, kind, batch, max_len, device=dev,
                             dtype=dtype) for kind in layer_kinds(cfg)]


def prefill_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 caches):
    """batch: ``{"tokens": (B, S)}`` (or ``"embeds"``); returns the last
    position's (B, vocab) float32 logits and the caches."""
    h = _embed_input(params, cfg, batch)
    h, new_caches = _run_stack(params, cfg, h, "prefill", caches)
    return _logits(params, cfg, h), new_caches


def decode_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                caches):
    """batch: one token per sequence, ``{"tokens": (B, 1)}``; caches from
    prefill. Returns (B, vocab) float32 logits and the caches."""
    h = _embed_input(params, cfg, batch)
    h, new_caches = _run_stack(params, cfg, h, "decode", caches)
    return _logits(params, cfg, h), new_caches
