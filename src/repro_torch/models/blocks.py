"""Residual blocks: one per pattern kind ('a', 'l', 'A', 'm', 'M').

Every block is pre-norm:  h += mixer(norm(h));  h += ffn(norm(h)).
The mixer is attention (full 'a' / 'A', sliding-window 'l') or mamba2 ('m',
'M'); the FFN a dense MLP (lowercase kinds), the MoE ('A', 'M') or none
(``d_ff == 0``, pure mamba2). Modes "train", "prefill" and "decode"; a
mamba block's cache is its :class:`~.mamba2.SSMState`, which its prefill
returns as the state after the prompt (the reference's leaves it at zero).
Under tensor parallelism the attention, the mamba2 mixer and the MLP split
over the ``tp`` line (``attention``, ``mamba2``, ``layers.mlp_apply``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ModelConfig
from .attention import (attn_decode, attn_init, attn_prefill, attn_train,
                        init_kv_cache)
from .layers import mlp_apply, mlp_init, rmsnorm, rmsnorm_init
from .mamba2 import (init_ssm_state, mamba_decode, mamba_init, mamba_prefill,
                     mamba_train)
from .moe import moe_apply, moe_init

__all__ = ["block_init", "block_apply", "block_cache_init", "is_attn",
           "is_moe", "is_mamba"]

MODES = ("train", "prefill", "decode")


def is_attn(kind: str) -> bool:
    return kind in "aAl"


def is_mamba(kind: str) -> bool:
    return kind in "mM"


def is_moe(kind: str) -> bool:
    return kind in "AM"


def _check_kind(kind: str) -> None:
    if not (is_attn(kind) or is_mamba(kind)):
        raise ValueError(f"unknown block kind {kind!r}")


def block_init(generator, cfg: ModelConfig, kind: str, *, device, dtype):
    _check_kind(kind)
    kw = dict(device=device, dtype=dtype)
    p = {"norm_mix": rmsnorm_init(cfg.d_model, **kw),
         "norm_ffn": rmsnorm_init(cfg.d_model, **kw)}
    if is_attn(kind):
        p["attn"] = attn_init(generator, cfg, **kw)
    else:
        p["mamba"] = mamba_init(generator, cfg, **kw)
    if is_moe(kind):
        p["moe"] = moe_init(generator, cfg, **kw)
    elif cfg.d_ff > 0:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp, **kw)
    # d_ff == 0 (pure mamba2): no FFN sublayer
    return p


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     *, device, dtype=torch.bfloat16, seq_parts: int = 1,
                     head_parts: int = 1):
    """A bf16 KV cache of ``max_len`` positions for attention kinds (this
    rank's block of them with ``seq_parts``); the float32
    :class:`~.mamba2.SSMState` for mamba kinds, this rank's heads with
    ``head_parts`` (``max_len``, ``dtype`` and ``seq_parts`` unused
    there)."""
    _check_kind(kind)
    if is_mamba(kind):
        return init_ssm_state(cfg, batch, device=device,
                              head_parts=head_parts)
    return init_kv_cache(cfg, batch, max_len, device=device, dtype=dtype,
                         seq_parts=seq_parts)


def block_apply(params, cfg: ModelConfig, kind: str, h,
                cache: Optional[Any] = None, mode: str = "prefill"):
    """Returns (h, new_cache, aux_loss). ``mode`` is "train" (no cache; the
    cache comes back as given), "prefill" or "decode"."""
    _check_kind(kind)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    window = cfg.window if kind == "l" else 0
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    x = rmsnorm(params["norm_mix"], h, cfg.norm_eps)
    if is_mamba(kind):
        if mode == "train":
            mix, new_cache = mamba_train(params["mamba"], cfg, x), cache
        elif mode == "prefill":
            mix, new_cache = mamba_prefill(params["mamba"], cfg, x)
        else:
            mix, new_cache = mamba_decode(params["mamba"], cfg, x, cache)
    elif mode == "train":
        mix, new_cache = attn_train(params["attn"], cfg, x,
                                    window=window), cache
    else:
        attend = attn_prefill if mode == "prefill" else attn_decode
        mix, new_cache = attend(params["attn"], cfg, x, cache, window=window)
    h = h + mix

    if is_moe(kind):
        x = rmsnorm(params["norm_ffn"], h, cfg.norm_eps)
        y, aux, _ = moe_apply(params["moe"], cfg, x)
        h = h + y
    elif "mlp" in params:
        x = rmsnorm(params["norm_ffn"], h, cfg.norm_eps)
        h = h + mlp_apply(params["mlp"], x, cfg.mlp, d_ff=cfg.d_ff)
    # else: pure-mamba block (d_ff == 0), mixer only
    return h, new_cache, aux
