"""Residual blocks: one per pattern kind.

Every block is pre-norm:  h += mixer(norm(h));  h += ffn(norm(h)).
Kinds of this slice: 'a' attention + MLP, 'l' sliding-window attention +
MLP, 'A' attention + MoE. The mamba kinds 'm' and 'M' come with the mamba2
slice and raise until then.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ModelConfig
from .attention import attn_decode, attn_init, attn_prefill, init_kv_cache
from .layers import mlp_apply, mlp_init, rmsnorm, rmsnorm_init
from .moe import moe_apply, moe_init

__all__ = ["block_init", "block_apply", "block_cache_init", "is_attn",
           "is_moe", "is_mamba"]

MODES = ("prefill", "decode")


def is_attn(kind: str) -> bool:
    return kind in "aAl"


def is_mamba(kind: str) -> bool:
    return kind in "mM"


def is_moe(kind: str) -> bool:
    return kind in "AM"


def _check_kind(kind: str) -> None:
    if is_mamba(kind):
        raise NotImplementedError(
            f"block kind {kind!r} (mamba) is not ported yet: it comes with "
            "the mamba2 slice of the port")
    if not is_attn(kind):
        raise ValueError(f"unknown block kind {kind!r}")


def block_init(generator, cfg: ModelConfig, kind: str, *, device, dtype):
    _check_kind(kind)
    kw = dict(device=device, dtype=dtype)
    p = {"norm_mix": rmsnorm_init(cfg.d_model, **kw),
         "norm_ffn": rmsnorm_init(cfg.d_model, **kw),
         "attn": attn_init(generator, cfg, **kw)}
    if is_moe(kind):
        p["moe"] = moe_init(generator, cfg, **kw)
    elif cfg.d_ff > 0:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp, **kw)
    return p


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     *, device, dtype=torch.bfloat16):
    _check_kind(kind)
    return init_kv_cache(cfg, batch, max_len, device=device, dtype=dtype)


def block_apply(params, cfg: ModelConfig, kind: str, h,
                cache: Optional[Any] = None, mode: str = "prefill"):
    """Returns (h, new_cache, aux_loss). ``mode`` is "prefill" or "decode";
    training comes with the training slice."""
    _check_kind(kind)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not ported yet; this slice "
                         f"serves ({', '.join(MODES)})")
    window = cfg.window if kind == "l" else 0
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    x = rmsnorm(params["norm_mix"], h, cfg.norm_eps)
    attend = attn_prefill if mode == "prefill" else attn_decode
    mix, new_cache = attend(params["attn"], cfg, x, cache, window=window)
    h = h + mix

    if is_moe(kind):
        x = rmsnorm(params["norm_ffn"], h, cfg.norm_eps)
        y, aux, _ = moe_apply(params["moe"], cfg, x)
        h = h + y
    elif "mlp" in params:
        x = rmsnorm(params["norm_ffn"], h, cfg.norm_eps)
        h = h + mlp_apply(params["mlp"], x, cfg.mlp)
    return h, new_cache, aux
