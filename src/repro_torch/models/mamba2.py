"""Mamba-2 (SSD — state-space duality) layer: chunked scan, prefill state and
decode step.

The port of ``repro.models.mamba2`` (Dao & Gu, arXiv:2405.21060): the
sequence is cut into chunks; within a chunk the output is a decay-masked
quadratic form, across chunks a linear recurrence carries the (heads,
head_dim, d_state) state. The reference computes all of it in plain
``jnp`` (no Pallas kernel), and so does the port in plain torch, with the
reference's casts: ``x @ w_in`` in the compute dtype, ``dt``, ``a`` and the
SSD in float32, ``y`` back to the compute dtype before the gated norm, the
decode conv in float32.

The reference's four-operand einsums are written as pairwise contractions
in a fixed order (no contraction-path optimizer on the card), each
intermediate at most one (B, chunks, heads, L, L) float32 tensor: the
decay matrix, 537 MB a layer at mamba2-1.3b, S 4096, B 2.

:func:`mamba_prefill` is the one addition: it also returns the state after
the prompt (the SSM state after the last real position and the conv tail),
which the reference's prefill leaves at zero (``repro/models/blocks.py``
hands the cache back unchanged in mode "prefill"). Decode
(:func:`mamba_decode`) is the pure recurrence: constant work and state per
new token, no KV cache.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import dense_init, rmsnorm

__all__ = ["mamba_init", "mamba_train", "mamba_prefill", "mamba_decode",
           "SSMState", "init_ssm_state"]


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, di + 2*ds) float32: the last raw xBC
    ssm: torch.Tensor     # (B, nh, hd, ds) float32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    return s, d, di, nh, s.d_state, s.head_dim, s.d_conv


def mamba_init(generator, cfg: ModelConfig, *, device, dtype):
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    kw = dict(device=device, dtype=dtype)
    conv_dim = di + 2 * ds
    conv_w = torch.randn((dc, conv_dim), generator=generator,
                         dtype=torch.float32, device=device)
    return {
        # projections: z (di), xBC (di + 2*ds), dt (nh)
        "w_in": dense_init(generator, d, 2 * di + 2 * ds + nh, **kw),
        "w_out": dense_init(generator, di, d, **kw),
        "conv_w": conv_w.mul_(1.0 / dc).to(dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device))
        .to(dtype),
        "dt_bias": torch.zeros((nh,), **kw),
        "d_skip": torch.ones((nh,), **kw),
        "norm": torch.ones((di,), **kw),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * ds]
    dt = zxbcdt[..., di + di + 2 * ds:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w):
    """Depthwise causal conv over seq in xbc's dtype, one tap at a time as
    the reference sums them. xbc: (B, S, C), conv_w: (K, C)."""
    k, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + s] * conv_w[i]
    return F.silu(out)


def _gated_norm(norm_scale, y, z, eps):
    return rmsnorm({"scale": norm_scale}, y * F.silu(z), eps)


def _segsum(x):
    """(..., L) -> (..., L, L) lower-triangular pairwise cumulative sums:
    out[i, j] = sum_{j < t <= i} x[t]  (-inf above the diagonal, whose exp
    is 0 and whose gradient through ``torch.where`` is 0)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(L, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -torch.inf)


def _ssd_chunked(x, da, b, c, chunk: int):
    """SSD core. x: (B,S,H,P); da: (B,S,H); b,c: (B,S,N). Returns (B,S,H,P)
    and the final inter-chunk state (B,H,P,N)."""
    B, S, H, Pd = x.shape
    N = b.shape[-1]
    nchunk = S // chunk
    xr = x.reshape(B, nchunk, chunk, H, Pd)
    dar = da.reshape(B, nchunk, chunk, H)
    br = b.reshape(B, nchunk, chunk, N)
    cr = c.reshape(B, nchunk, chunk, N)

    # intra-chunk (diagonal blocks): decay-masked quadratic attention,
    # "bcln,bcsn,bchls,bcshp->bclhp" as (C Bᵀ) ∘ L, then times x
    da_t = dar.transpose(2, 3)                           # (B,C,H,L)
    lmat = torch.exp(_segsum(da_t))                      # (B,C,H,L,L)
    cb = torch.matmul(cr, br.transpose(2, 3))            # (B,C,L,L)
    w = cb[:, :, None] * lmat                            # (B,C,H,L,L)
    y_diag = torch.matmul(w, xr.permute(0, 1, 3, 2, 4))  # (B,C,H,L,P)

    # chunk summary states: decayed outer products B ⊗ x,
    # "bcln,bchl,bclhp->bchpn" as (x · decay) then contracted with B over l
    cum = torch.cumsum(da_t, dim=-1)                     # (B,C,H,L)
    decay_states = torch.exp(cum[..., -1:] - cum)        # (B,C,H,L)
    xd = xr * decay_states.transpose(2, 3)[..., None]    # (B,C,L,H,P)
    states = torch.matmul(xd.reshape(B, nchunk, chunk, H * Pd)
                          .transpose(2, 3), br)          # (B,C,H*P,N)
    states = states.reshape(B, nchunk, H, Pd, N)

    # inter-chunk recurrence: S_{c+1} = exp(sum dA_c) S_c + states_c; each
    # chunk reads the state before it
    chunk_decay = torch.exp(cum[..., -1])                # (B,C,H)
    carry = torch.zeros((B, H, Pd, N), dtype=x.dtype, device=x.device)
    prev = []
    for i in range(nchunk):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)               # (B,C,H,P,N)

    # contribution of the carried state to each position in the chunk,
    # "bcln,bchpn,bchl->bclhp" as C · state, then times the decay
    state_decay = torch.exp(cum)                         # (B,C,H,L)
    y_off = torch.matmul(cr, prev_states.permute(0, 1, 4, 2, 3)
                         .reshape(B, nchunk, N, H * Pd))  # (B,C,L,H*P)
    y_off = y_off.reshape(B, nchunk, chunk, H, Pd) \
        * state_decay.transpose(2, 3)[..., None]
    y = (y_diag.permute(0, 1, 3, 2, 4) + y_off).reshape(B, S, H, Pd)
    return y, carry


def mamba_prefill(params, cfg: ModelConfig,
                  x) -> Tuple[torch.Tensor, SSMState]:
    """The whole-sequence layer: (B, S, d) -> (B, S, d) and the state after
    the prompt, from which :func:`mamba_decode` continues: the SSM state
    after position S - 1 and the last ``d_conv - 1`` rows of the raw
    (pre-conv) xBC, zero-filled on the left when S < d_conv - 1, both
    float32. S is padded on the right up to a chunk multiple; at pad
    positions ``da`` and ``dt·x`` are 0, so the final state is the last
    real position's (outputs at real positions are causal and do not
    change)."""
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    B, S, _ = x.shape
    chunk = min(s.chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))

    zxbcdt = x @ params["w_in"]
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc_raw, params["conv_w"])
    xs = xbc[..., :di].reshape(B, S + pad, nh, hd)
    b = xbc[..., di:di + ds]
    c = xbc[..., di + ds:]

    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    da = dt * a                                          # (B,S,nh)
    xdt = xs * dt[..., None]
    if pad:
        real = (torch.arange(S + pad, device=x.device) < S)[None, :, None]
        da = torch.where(real, da, 0.0)
        xdt = torch.where(real[..., None], xdt, 0.0)

    y, final = _ssd_chunked(xdt.float(), da, b.float(), c.float(), chunk)
    y = y + xs.float() * params["d_skip"].float()[None, None, :, None]
    y = y.reshape(B, S + pad, di).to(x.dtype)
    y = _gated_norm(params["norm"], y, z, cfg.norm_eps)
    out = y @ params["w_out"]

    tail = xbc_raw[:, max(0, S - (dc - 1)):S].float()
    if tail.shape[1] < dc - 1:                           # S < d_conv - 1
        tail = F.pad(tail, (0, 0, dc - 1 - tail.shape[1], 0))
    return out[:, :S], SSMState(conv=tail, ssm=final)


def mamba_train(params, cfg: ModelConfig, x):
    """x: (B, S, d) -> (B, S, d); any S (padded to a chunk multiple
    inside)."""
    return mamba_prefill(params, cfg, x)[0]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_ssm_state(cfg: ModelConfig, batch: int, *, device) -> SSMState:
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, dc - 1, di + 2 * ds), dtype=torch.float32,
                         device=device),
        ssm=torch.zeros((batch, nh, hd, ds), dtype=torch.float32,
                        device=device))


def mamba_decode(params, cfg: ModelConfig, x,
                 state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, 1, d) -> (B, 1, d); O(1) state update."""
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    B = x.shape[0]
    zxbcdt = x[:, 0] @ params["w_in"]                    # (B, ...)
    z, xbc, dt = _split_proj(cfg, zxbcdt)

    # conv ring buffer: window = [conv_state, xbc], in float32
    win = torch.cat([state.conv, xbc[:, None].to(state.conv.dtype)], dim=1)
    conv_out = F.silu((win.float() * params["conv_w"].float()).sum(dim=1))
    new_conv = win[:, 1:]

    xs = conv_out[..., :di].reshape(B, nh, hd)
    b = conv_out[..., di:di + ds]
    c = conv_out[..., di + ds:]
    dt = F.softplus(dt.float() + params["dt_bias"].float())  # (B,nh)
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt * a)                            # (B,nh)

    # h <- decay * h + dt * x ⊗ B ; y = h · C + D * x
    upd = (xs * dt[..., None])[..., None] * b[:, None, None, :]
    h = state.ssm * decay[..., None, None] + upd
    y = torch.matmul(h, c[:, None, :, None])[..., 0]     # (B,nh,hd)
    y = y + xs * params["d_skip"].float()[None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = _gated_norm(params["norm"], y, z[:, None], cfg.norm_eps)
    return y @ params["w_out"], SSMState(conv=new_conv, ssm=h)
