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

Under tensor parallelism (``tensor_parallel.tp_group``: the ``default``,
``serve_tp`` and ``ep_sharded`` profiles) each leaf keeps the layout its
spec gives it: ``w_in`` this rank's contiguous block of the ``z | x | B |
C | dt`` columns, ``conv_w`` its block of the conv channels, ``w_out`` its
rows, ``a_log`` / ``dt_bias`` / ``d_skip`` / ``norm`` whole. Where the
line divides the heads, a rank computes its heads: ``x`` enters through
``tp_copy``, its block of the projection is regrouped
(``tensor_parallel.regroup``: each head's z, x and dt to the head's
owner, B and C to every rank), ``conv_w`` is gathered whole (its
gradient's parts summed back to each block), the replicated leaves give
their heads' entries through ``tp_copy``, the SSD runs on the rank's heads
with no communication, the gated norm's sum of squares is summed over the
line (``tensor_parallel.line_sum``) and ``w_out``'s parts are summed
(``row_parallel``). The state holds the rank's heads, its conv tail the
rank's x channels and B and C. Where the line does not divide the heads
(the reference then keeps the state whole), every rank runs the whole
mixer: the split columns gathered (``tp_gather``) and ``w_out`` used as
its spec holds it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.collectives import all_gather_cat, tp_copy, tp_gather, tp_split
from .layers import dense_init, rmsnorm
from .tensor_parallel import TP, line_sum, regroup, row_parallel, tp_group

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


class _Heads(NamedTuple):
    """The heads ``[h0, h0 + nh)`` a rank computes and its tp line (None
    in one process); ``split``: the line divides the heads (else every
    rank computes all of them)."""
    tp: Optional[TP]
    split: bool
    nh: int
    h0: int


def _heads(cfg: ModelConfig) -> _Heads:
    nh = _dims(cfg)[3]
    tp = tp_group()
    if tp is None or not tp.splits(nh):
        return _Heads(tp, False, nh, 0)
    return _Heads(tp, True, nh // tp.size, tp.index * (nh // tp.size))


def _split_proj(cfg: ModelConfig, zxbcdt, di: Optional[int] = None):
    """z, xBC and dt of a projection whose z and x are ``di`` wide (the
    config's by default; a rank's heads' under tensor parallelism)."""
    s, d, whole, nh, ds, hd, dc = _dims(cfg)
    di = whole if di is None else di
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * ds]
    dt = zxbcdt[..., di + di + 2 * ds:]
    return z, xbc, dt


def _need(cfg: ModelConfig, p: int):
    """Per member of a line of ``p`` that splits the heads, the columns of
    ``w_in``'s ``z | x | B | C | dt`` it uses: its heads' z and x, B and C
    whole, its heads' dt."""
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    w, n = di // p, nh // p
    return [((q * w, (q + 1) * w), (di + q * w, di + (q + 1) * w),
             (2 * di, 2 * di + 2 * ds),
             (2 * di + 2 * ds + q * n, 2 * di + 2 * ds + (q + 1) * n))
            for q in range(p)]


def _in_proj(params, cfg: ModelConfig, x, hs: _Heads):
    """This rank's z, raw xBC (its heads' x channels, then B and C) and dt
    of ``x @ w_in``."""
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    w, tp = params["w_in"], hs.tp
    whole = w.shape[1] == 2 * di + 2 * ds + nh
    if tp is None or (whole and not hs.split):
        return _split_proj(cfg, x @ w)
    xin = tp_copy(x, tp.comm, tp.dims)
    if not hs.split:                  # every rank runs the whole mixer
        return _split_proj(cfg, tp_gather(xin @ w, tp.comm, tp.dims,
                                          x.ndim - 1))
    need = _need(cfg, tp.size)
    if whole:                         # the rules keep w_in whole
        cols = torch.cat([torch.arange(a, b, device=w.device)
                          for a, b in need[tp.index]])
        zx = xin @ tp_copy(w, tp.comm, tp.dims).index_select(1, cols)
    else:
        zx = regroup(xin @ w, tp, need)
    return _split_proj(cfg, zx, hs.nh * hd)


def _local(params, cfg: ModelConfig, hs: _Heads):
    """The leaves the rank's heads read: ``conv_w`` of its channels (its
    heads' x, then B and C), and ``a_log``, ``dt_bias``, ``d_skip`` and
    ``norm`` of its heads. A split ``conv_w`` is gathered whole first:
    where the line splits the heads each rank's gradient is a part
    (``all_gather_cat``: the parts summed back to each block), where it
    does not the whole (``tp_gather``: the rank's block of it). A
    replicated leaf read only in part goes through ``tp_copy``."""
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    names = ("conv_w", "a_log", "dt_bias", "d_skip", "norm")
    out = {k: params[k] for k in names}
    tp = hs.tp
    if tp is None:
        return out
    cw = out["conv_w"]
    if cw.shape[1] != di + 2 * ds:
        cw = (all_gather_cat(cw, tp.comm, tp.dims, "tp", dim=1) if hs.split
              else tp_gather(cw, tp.comm, tp.dims, 1))
    elif hs.split:
        cw = tp_copy(cw, tp.comm, tp.dims)
    out["conv_w"] = cw
    if not hs.split:
        return out
    h0, h1 = hs.h0, hs.h0 + hs.nh
    out["conv_w"] = torch.cat([cw[:, h0 * hd:h1 * hd], cw[:, di:]], dim=1)
    for k in ("a_log", "dt_bias", "d_skip"):
        out[k] = tp_copy(out[k], tp.comm, tp.dims)[h0:h1]
    out["norm"] = tp_copy(out["norm"], tp.comm, tp.dims)[h0 * hd:h1 * hd]
    return out


def _out_proj(y, params, cfg: ModelConfig, hs: _Heads):
    """``y @ w_out`` for ``y`` the rank's heads' (or every head's)
    channels: the row-split parts summed over the line where the rules
    split ``w_out``'s rows."""
    w, tp = params["w_out"], hs.tp
    if tp is None or (w.shape[0] == _dims(cfg)[2] and not hs.split):
        return y @ w
    if not hs.split:                  # the whole mixer, w_out's rows split
        y = tp_split(y, tp.comm, tp.dims, y.ndim - 1)
    return row_parallel(y, w, tp)


def _causal_conv(xbc, conv_w):
    """Depthwise causal conv over seq in xbc's dtype, one tap at a time as
    the reference sums them. xbc: (B, S, C), conv_w: (K, C)."""
    k, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + s] * conv_w[i]
    return F.silu(out)


def _gated_norm(norm_scale, y, z, eps, tp: Optional[TP] = None, di=0):
    """rmsnorm(y · silu(z)) over ``di`` channels. With ``tp``, ``y``, ``z``
    and ``norm_scale`` are a rank's heads' channels: the float32 sum of
    squares of its channels is summed over the line
    (``tensor_parallel.line_sum``) before the mean."""
    if tp is None:
        return rmsnorm({"scale": norm_scale}, y * F.silu(z), eps)
    g = y * F.silu(z)
    gf = g.float()
    var = line_sum((gf * gf).sum(dim=-1, keepdim=True), tp) / di
    return (gf * torch.rsqrt(var + eps)
            * norm_scale.float()).to(g.dtype)


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
    float32 (of the rank's heads and channels under tensor parallelism).
    S is padded on the right up to a chunk multiple; at pad positions
    ``da`` and ``dt·x`` are 0, so the final state is the last real
    position's (outputs at real positions are causal and do not
    change)."""
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    B, S, _ = x.shape
    chunk = min(s.chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))

    hs = _heads(cfg)
    lp = _local(params, cfg, hs)
    dr = hs.nh * hd                                      # the rank's di
    z, xbc_raw, dt = _in_proj(params, cfg, x, hs)
    xbc = _causal_conv(xbc_raw, lp["conv_w"])
    xs = xbc[..., :dr].reshape(B, S + pad, hs.nh, hd)
    b = xbc[..., dr:dr + ds]
    c = xbc[..., dr + ds:]

    dt = F.softplus(dt.float() + lp["dt_bias"].float())
    a = -torch.exp(lp["a_log"].float())
    da = dt * a                                          # (B,S,nh)
    xdt = xs * dt[..., None]
    if pad:
        real = (torch.arange(S + pad, device=x.device) < S)[None, :, None]
        da = torch.where(real, da, 0.0)
        xdt = torch.where(real[..., None], xdt, 0.0)

    y, final = _ssd_chunked(xdt.float(), da, b.float(), c.float(), chunk)
    y = y + xs.float() * lp["d_skip"].float()[None, None, :, None]
    y = y.reshape(B, S + pad, dr).to(x.dtype)
    y = _gated_norm(lp["norm"], y, z, cfg.norm_eps,
                    hs.tp if hs.split else None, di)
    out = _out_proj(y, params, cfg, hs)

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

def init_ssm_state(cfg: ModelConfig, batch: int, *, device,
                   head_parts: int = 1) -> SSMState:
    """Zeros; with ``head_parts`` P (a tp line that divides the heads),
    a rank's state: its nh/P heads, its conv tail of their x channels and
    B and C."""
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    if nh % head_parts:
        raise ValueError(f"{head_parts} parts do not divide {nh} heads")
    return SSMState(
        conv=torch.zeros((batch, dc - 1, di // head_parts + 2 * ds),
                         dtype=torch.float32, device=device),
        ssm=torch.zeros((batch, nh // head_parts, hd, ds),
                        dtype=torch.float32, device=device))


def _recur(ssm, xdt, decay, b, c):
    """One step of h <- decay * h + dt·x ⊗ B; returns (h · C, h)."""
    upd = xdt[..., None] * b[:, None, None, :]
    h = ssm * decay[..., None, None] + upd
    return torch.matmul(h, c[:, None, :, None])[..., 0], h   # (B,nh,hd)


def mamba_decode(params, cfg: ModelConfig, x,
                 state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, 1, d) -> (B, 1, d); O(1) state update (the rank's heads
    under tensor parallelism)."""
    s, d, di, nh, ds, hd, dc = _dims(cfg)
    B = x.shape[0]
    hs = _heads(cfg)
    lp = _local(params, cfg, hs)
    dr = hs.nh * hd
    z, xbc, dt = _in_proj(params, cfg, x[:, 0], hs)      # (B, ...)

    # conv ring buffer: window = [conv_state, xbc], in float32
    win = torch.cat([state.conv, xbc[:, None].to(state.conv.dtype)], dim=1)
    conv_out = F.silu((win.float() * lp["conv_w"].float()).sum(dim=1))
    new_conv = win[:, 1:]

    xs = conv_out[..., :dr].reshape(B, hs.nh, hd)
    b = conv_out[..., dr:dr + ds]
    c = conv_out[..., dr + ds:]
    dt = F.softplus(dt.float() + lp["dt_bias"].float())  # (B,nh)
    a = -torch.exp(lp["a_log"].float())
    decay = torch.exp(dt * a)                            # (B,nh)

    # y = h · C + D * x
    y, h = _recur(state.ssm, xs * dt[..., None], decay, b, c)
    y = y + xs * lp["d_skip"].float()[None, :, None]
    y = y.reshape(B, 1, dr).to(x.dtype)
    y = _gated_norm(lp["norm"], y, z[:, None], cfg.norm_eps,
                    hs.tp if hs.split else None, di)
    return _out_proj(y, params, cfg, hs), SSMState(conv=new_conv, ssm=h)
