"""Shared neural layers: norms, RoPE, MLP variants, init helpers.

Functional, as in ``repro.models.layers``: ``*_init(generator, ...) ->
params`` (nested dicts of tensors) and ``*_apply(params, x, ...) -> y``,
with the reference's parameter names. Init draws each tensor in float32
from an explicit ``torch.Generator`` on the target device and casts it to
the requested dtype before the next one is drawn. The draws do not match
``jax.random``'s: tests hand the reference's weights over through
``models.convert.params_from_reference``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "compute_dtype", "trunc_normal", "dense_init", "rmsnorm_init", "rmsnorm",
    "rope", "mlp_init", "gate_act", "mlp_apply", "softcap",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    return _DTYPES[name]


def trunc_normal(generator, shape, scale: float, *, device, dtype):
    """Normal draws truncated to [-2, 2], times ``scale``, drawn in float32
    and returned in ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def dense_init(generator, in_dim: int, out_dim: int, *, device, dtype):
    return trunc_normal(generator, (in_dim, out_dim), in_dim ** -0.5,
                        device=device, dtype=dtype)


def rmsnorm_init(dim: int, *, device, dtype):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """RMS norm computed in float32, returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def softcap(x, cap: float):
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding over the two halves of the last dim.

    x: (..., S, H, D); positions: (..., S) integer absolute positions.
    """
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants: swiglu (llama-family), geglu (gemma), relu2 (nemotron)
# ---------------------------------------------------------------------------

def mlp_init(generator, d_model: int, d_ff: int, kind: str, *, device,
             dtype):
    p = {"w_up": dense_init(generator, d_model, d_ff, device=device,
                            dtype=dtype),
         "w_down": dense_init(generator, d_ff, d_model, device=device,
                              dtype=dtype)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(generator, d_model, d_ff, device=device,
                                 dtype=dtype)
    return p


def gate_act(g, kind: str):
    """The gate's activation: silu for swiglu, tanh-approximated gelu for
    geglu."""
    if kind == "swiglu":
        return F.silu(g)
    if kind == "geglu":
        return F.gelu(g, approximate="tanh")
    raise ValueError(kind)


def mlp_apply(params, x, kind: str):
    up = x @ params["w_up"]
    if kind in ("swiglu", "geglu"):
        h = gate_act(x @ params["w_gate"], kind) * up
    elif kind == "relu2":
        r = F.relu(up)
        h = r * r                      # squared-ReLU (nemotron-4)
    else:
        raise ValueError(kind)
    return h @ params["w_down"]
