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
its tokens exactly.

Across ranks (``sharding.use_rules``, each rank holding its slab of a
batch split over ``rules.batch``), :func:`moe_apply` takes one of two
paths, by the reference's condition on the *global* batch:

  * ``_moe_shard_map`` (the ``ep_dp`` profile: experts sharded over the
    model axis) — the reference's explicit expert parallelism. Each rank
    routes its own slab with a capacity from its own token count, one
    tiled all-to-all sends each expert's (E, C, d) bucket block to the
    expert's owner, which receives (E/P, P·C, d), runs its experts, and a
    reverse all-to-all brings the outputs home. Each source block's live
    rows are a prefix of that block, not of the P·C rows, so the rows
    counts travel with the buckets and the owner packs the live rows to
    the front of each expert before the grouped GEMMs (and unpacks after):
    the ``rows`` contract holds, and an expert no token reached costs no
    weight read. Both exchanges are dispatcher ops
    (``collectives.all_to_all`` of kind ``"a2a"`` / ``dispatch_exchange``),
    whose results remat ``"dots"`` saves. ``aux`` is averaged and the metrics
    summed over all ranks.
    Under ``ep_sharded`` (tensor parallelism, the sequence divisible by
    the line) each rank routes its block of the sequence the same way.
  * otherwise (``dp_only``, ``default``, and ``ep_sharded`` where the line
    does not divide the sequence, as in every decode step) — the
    reference's default path over the global batch: the capacity comes
    from the global token count, and each assignment's place in its
    expert's queue counts the assignments of the ranks before it, so the
    same assignments are dropped as in one process; the load-balance loss
    uses the global counts and mean probabilities. Under tensor
    parallelism the ``model`` line routes the same tokens, each rank runs
    the buckets of its E/P experts (the rules split the expert leaves over
    ``model``) and the outputs are gathered over the line before the
    combine; the shared experts are a Megatron pair.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..configs.base import ModelConfig, MoEConfig
from ..core.collectives import (all_to_all, dispatch_exchange, mesh_comm,
                                psum, tp_copy, tp_gather, tp_split)
from ..kernels.moe_gemm import grouped_gemm
from ..sharding.rules import check_executable, current_rules
from .layers import dense_init, gate_act, mlp_apply, mlp_init, trunc_normal
from .tensor_parallel import tp_group

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


def _shared_ff(moe: MoEConfig) -> int:
    return moe.n_shared * moe.d_ff_shared


def _expert_ffn(cfg: ModelConfig, bkts, rows, eg, eu, ed):
    up = grouped_gemm(bkts, eu, rows)
    if eg is not None:
        h = gate_act(grouped_gemm(bkts, eg, rows), cfg.mlp) * up
    else:
        r = torch.relu(up)
        h = r * r
    return grouped_gemm(h, ed, rows)


class _Ranks:
    """The ranks that split the batch (the global path's peers)."""

    def __init__(self, comm, dims):
        self.comm, self.dims = comm, tuple(dims)
        self.size = comm.size(self.dims)

    def before(self, counts):
        """Per expert, the assignments of the ranks before this one."""
        every = self.comm.gather(counts, self.dims, "reduce")
        return every[:self.comm.index(self.dims)].sum(0)

    def psum(self, x):
        return psum(x, self.comm, self.dims)


def _route_and_combine(cfg: ModelConfig, router, shared, xf,
                       run_experts: Callable, ranks: Optional[_Ranks] = None):
    """Routing + capacity bucketing + combine on a flat (T, d) slab.

    ``run_experts``: ((E, C, d) buckets, (E,) int32 live rows per expert)
    -> (E, C, d) outputs. ``ranks``: the slab is this rank's part of a
    global batch of ``ranks.size`` equal slabs, routed as one (global
    capacity and queue places, global aux and metrics).
    """
    moe = cfg.moe
    t, d = xf.shape
    e = moe.n_experts_padded
    k = moe.top_k
    t_all = t * (ranks.size if ranks else 1)
    cap = _capacity(moe, t_all)
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
    counts = bounds[1:] - run_start
    room = cap - ranks.before(counts) if ranks else \
        torch.full_like(counts, cap)                         # queue left
    rows = torch.minimum(counts, room.clamp(min=0)).int()    # live rows
    rank = torch.arange(t * k, device=dev) - run_start[se]
    keep = rank < room[se]                                   # capacity drop
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
        y = y + mlp_apply(shared, xf, cfg.mlp, d_ff=_shared_ff(moe))

    # ---- aux: load balancing + paper-style traffic accounting --------------
    tokens = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones(t * k, dtype=torch.float32, device=dev))
    mean_probs = probs.mean(0)
    routed, dropped = keep.sum(), (~keep).sum()
    if ranks:
        tokens = ranks.psum(tokens)
        mean_probs = ranks.psum(probs.sum(0)) / t_all
        routed, dropped = ranks.psum(torch.stack([routed, dropped])).unbind()
    frac_tokens = tokens / (t_all * k)
    aux = moe.n_experts * torch.sum(frac_tokens * mean_probs) \
        * moe.router_aux_weight
    metrics = {
        "moe/routed_tokens": routed,                 # exact (required)
        "moe/capacity_slots": torch.tensor(e * cap, device=dev),  # fetched
        "moe/dropped": dropped,
    }
    return y, aux, metrics


def _packing(rows_in: torch.Tensor, cap: int):
    """For received (E/P, P·C, d) buckets whose source block s holds
    ``rows_in[s, e]`` live rows of expert e at its front: the gather index
    that moves every expert's live rows to its front (source order kept),
    its inverse, and the (E/P,) live-row totals."""
    p, el = rows_in.shape
    pos = torch.arange(p * cap, device=rows_in.device) % cap
    live = pos[None, :] < rows_in.t().repeat_interleave(cap, dim=1)
    order = torch.sort((~live).to(torch.int32), dim=1, stable=True).indices
    inverse = torch.empty_like(order).scatter_(
        1, order, torch.arange(p * cap, device=order.device)
        .expand(el, -1).contiguous())
    return order, inverse, live.sum(1).int()


def _take_rows(x, index):
    return x.gather(1, index[..., None].expand(-1, -1, x.shape[-1]))


def _moe_shard_map(params, cfg: ModelConfig, x, rules, tp=None):
    """Explicit EP on this rank's (b, s, d) slab: local routing, a tiled
    all-to-all of the bucket blocks to the experts' owners over
    ``rules.expert_axis``, the local experts (``params``' expert leaves are
    this rank's E/P), the reverse all-to-all. Under ``ep_dp`` the expert
    axis is part of data parallelism, so the sequence stays whole. Under
    ``ep_sharded`` (``tp``, the expert axis) the line holds the same slab:
    each rank routes its block of the sequence (``tp_split``, the router
    through ``tp_copy``: its gradient on a rank is its block's part), the
    blocks' outputs are joined along the sequence (``tp_gather``), and the
    shared experts run as a Megatron pair on the whole slab."""
    comm = mesh_comm(rules.mesh)
    ep = (rules.expert_axis,)
    eg = params.get("experts_gate")
    shared = params.get("shared") if cfg.moe.n_shared else None
    router = params["router"]
    whole = x
    if tp is not None:
        x = tp_split(x, tp.comm, tp.dims, 1)
        router = tp_copy(router, tp.comm, tp.dims)
        shared = None
    b, s, d = x.shape

    def run(bkts, rows):
        cap = bkts.shape[1]
        recv = all_to_all(bkts, comm, ep, 0, 1, "a2a")    # (E/P, P·C, d)
        rows_in = dispatch_exchange(rows, comm, ep)       # (P, E/P)
        order, inverse, live = _packing(rows_in, cap)
        out = _expert_ffn(cfg, _take_rows(recv, order), live, eg,
                          params["experts_up"], params["experts_down"])
        return all_to_all(_take_rows(out, inverse), comm, ep, 1, 0, "a2a")

    y, aux, metrics = _route_and_combine(
        cfg, router, shared, x.reshape(b * s, d), run)
    y = y.reshape(b, s, d)
    if tp is not None:
        y = tp_gather(y, tp.comm, tp.dims, 1)
        if cfg.moe.n_shared:
            y = y + mlp_apply(params["shared"], whole, cfg.mlp,
                              d_ff=_shared_ff(cfg.moe))
    every = tuple(dict.fromkeys(tuple(rules.batch or ()) + ep))
    # one reduce for the aux loss and the metrics: float64 holds the counts
    # exactly
    summed = psum(torch.stack([aux.double()] + [v.double() for v in
                                                metrics.values()]),
                  comm, every)
    aux = summed[0].float() / comm.size(every)
    return y, aux, {k: v.long() for k, v in zip(metrics, summed[1:].unbind())}


def moe_apply(params, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                    torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux_loss, metrics). Under rules, ``x`` is this
    rank's slab of a global batch of ``B * rules.batch_size``."""
    b, s, d = x.shape
    moe = cfg.moe
    rules = current_rules()
    ranks = tp = None
    if rules is not None:
        # the reference's condition, less a clause that holds here:
        # batch_slab refuses a global batch the batch axes do not divide
        check_executable(rules, cfg)
        tp = tp_group()
        if (rules.ep_shard_map and rules.expert_axis is not None
                and rules.mesh is not None
                and (tp is None or s % tp.size == 0)
                and moe.n_experts_padded
                % rules.axis_size(rules.expert_axis) == 0):
            return _moe_shard_map(params, cfg, x, rules, tp)
        ranks = _Ranks(mesh_comm(rules.mesh), rules.batch)
    eg = params.get("experts_gate")
    shared = params.get("shared") if moe.n_shared else None
    # under tensor parallelism each rank runs its E/P experts' buckets of
    # the tokens the line routes alike (the reference's GSPMD path shards
    # the buckets over the expert axis), and the outputs are joined
    split = tp is not None and params["experts_up"].shape[0] \
        < moe.n_experts_padded

    def run(bkts, rows):
        if split:
            bkts = tp_split(bkts, tp.comm, tp.dims, 0)
            rows = rows.chunk(tp.size)[tp.index]
        out = _expert_ffn(cfg, bkts, rows, eg, params["experts_up"],
                          params["experts_down"])
        return tp_gather(out, tp.comm, tp.dims, 0) if split else out

    y, aux, metrics = _route_and_combine(
        cfg, params["router"], shared, x.reshape(b * s, d), run, ranks)
    return y.reshape(b, s, d), aux, metrics
