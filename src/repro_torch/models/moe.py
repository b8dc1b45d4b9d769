"""MoE layer — the paper's 1D SpGEMM transplanted to expert parallelism.

The single-device path of ``repro.models.moe``. The router's token→expert
assignment is a sparse boolean matrix R (tokens × experts, top-k nonzeros
per row). Dispatch computes Xᵉ = RᵀX into capacity buckets, the expert FFN
runs as a grouped GEMM over the buckets (the hand-written ``moe_gemm``
kernels on a card), and combine computes Y = R·(gates ⊙ FFNᵉ(Xᵉ)).

Each expert's fill, ``rows[e] = min(count_e, cap)``, comes from the run
starts on the device and goes to every grouped GEMM: bucket rows at and past
it are zero, stay zero through the gated activation (silu(0)·0 = 0,
relu(0)² = 0) and are never read by the combine (a dropped assignment reads
slot cap-1 of a full expert with gate 0), so the kernels skip them and the
outputs are what they would be without ``rows``.

The reference's semantics are kept exactly: ``_capacity``'s integer math,
padded experts masked to -1e30 before the softmax, a stable sort of the
flat expert ids, ``searchsorted`` run starts, the capacity-drop ``keep``
mask, and an ``index_add_`` into the buckets. The combine adds each
token's k contributions through a gather by the inverse sort and a sum
over k, not an ``index_add_``: on a card ``index_add_`` adds with atomics
in an order that changes from run to run, and greedy serving must repeat
its tokens exactly. The expert-parallel ``shard_map`` path waits for the
multi-rank backend.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..configs.base import ModelConfig, MoEConfig
from ..kernels.moe_gemm import grouped_gemm
from .layers import dense_init, gate_act, mlp_apply, mlp_init, trunc_normal

__all__ = ["moe_init", "moe_apply"]


def moe_init(generator, cfg: ModelConfig, *, device, dtype):
    moe = cfg.moe
    d = cfg.d_model
    e = moe.n_experts_padded
    kw = dict(device=device, dtype=dtype)
    p = {
        "router": dense_init(generator, d, e, **kw),
        "experts_up": trunc_normal(generator, (e, d, moe.d_ff_expert),
                                   d ** -0.5, **kw),
        "experts_down": trunc_normal(generator, (e, moe.d_ff_expert, d),
                                     moe.d_ff_expert ** -0.5, **kw),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["experts_gate"] = trunc_normal(generator, (e, d, moe.d_ff_expert),
                                         d ** -0.5, **kw)
    if moe.n_shared:
        p["shared"] = mlp_init(generator, d, moe.n_shared * moe.d_ff_shared,
                               cfg.mlp, **kw)
    return p


def _capacity(moe: MoEConfig, n_tokens: int) -> int:
    c = int(n_tokens * moe.top_k / moe.n_experts * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)  # multiple of 8 lanes


def _expert_ffn(cfg: ModelConfig, bkts, rows, eg, eu, ed):
    up = grouped_gemm(bkts, eu, rows)
    if eg is not None:
        h = gate_act(grouped_gemm(bkts, eg, rows), cfg.mlp) * up
    else:
        r = torch.relu(up)
        h = r * r
    return grouped_gemm(h, ed, rows)


def _route_and_combine(cfg: ModelConfig, router, shared, xf,
                       run_experts: Callable):
    """Routing + capacity bucketing + combine on a flat (T, d) slab.

    ``run_experts``: ((E, C, d) buckets, (E,) int32 live rows per expert)
    -> (E, C, d) outputs.
    """
    moe = cfg.moe
    t, d = xf.shape
    e = moe.n_experts_padded
    k = moe.top_k
    cap = _capacity(moe, t)
    dev = xf.device

    logits = (xf @ router).float()                           # (T, E)
    if e > moe.n_experts:
        logits = torch.where(torch.arange(e, device=dev)[None, :]
                             >= moe.n_experts, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)                # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)

    # ---- symbolic phase: capacity-bucketed dispatch plan -------------------
    flat_e = ids.reshape(-1)                                 # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    st_, sg = flat_t[order], flat_g[order]
    bounds = torch.searchsorted(se, torch.arange(e + 1, device=dev))
    run_start = bounds[:-1]                                  # (E,)
    rows = (bounds[1:] - run_start).clamp(max=cap).int()     # live rows
    rank = torch.arange(t * k, device=dev) - run_start[se]
    keep = rank < cap                                        # capacity drop
    slot = se * cap + rank.clamp(0, cap - 1)                 # (T*k,)

    buckets = torch.zeros((e * cap, d), dtype=xf.dtype, device=dev)
    buckets.index_add_(0, slot, torch.where(keep[:, None], xf[st_], 0.0))
    out = run_experts(buckets.reshape(e, cap, d), rows).reshape(e * cap, d)

    # ---- combine: Y = R (gates ⊙ expert outputs) ---------------------------
    contrib = out[slot] * (sg * keep)[:, None].to(xf.dtype)  # sorted order
    per_token = torch.empty_like(contrib)
    per_token[order] = contrib                               # (T*k, d)
    y = per_token.reshape(t, k, d).sum(dim=1)
    if shared is not None:
        y = y + mlp_apply(shared, xf, cfg.mlp)

    # ---- aux: load balancing + paper-style traffic accounting --------------
    frac_tokens = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones(t * k, dtype=torch.float32, device=dev)) \
        / (t * k)
    aux = moe.n_experts * torch.sum(frac_tokens * probs.mean(0)) \
        * moe.router_aux_weight
    metrics = {
        "moe/routed_tokens": keep.sum(),             # exact (required)
        "moe/capacity_slots": torch.tensor(e * cap, device=dev),  # fetched
        "moe/dropped": (~keep).sum(),
    }
    return y, aux, metrics


def moe_apply(params, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                    torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux_loss, metrics)."""
    b, s, d = x.shape
    eg = params.get("experts_gate")
    shared = params.get("shared") if cfg.moe.n_shared else None

    def run(bkts, rows):
        return _expert_ffn(cfg, bkts, rows, eg, params["experts_up"],
                           params["experts_down"])

    y, aux, metrics = _route_and_combine(
        cfg, params["router"], shared, x.reshape(b * s, d), run)
    return y.reshape(b, s, d), aux, metrics
