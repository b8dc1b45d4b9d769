"""The LM: embedding → layer stack → final norm → (tied) logits.

The entry points of ``repro.models.transformer``:

  * :func:`loss_fn`      — next-token cross entropy + MoE aux (training)
  * :func:`train_logits` — full (B, S, vocab) logits + aux
  * :func:`prefill_step` — last-position logits + populated caches
  * :func:`decode_step`  — one token per sequence against the caches

The reference stacks each pattern position's parameters over periods and
scans them; here the stack is a plain list of per-layer dicts run in a
Python loop (layer ``l`` has kind ``cfg.pattern[l % len(cfg.pattern)]``),
on one card in one process, so the reference's sharding annotations have
no counterpart. Every block kind runs in every mode; a mamba layer's
prefill returns the state after the prompt, which the reference's leaves
at zero (see ``blocks.py``).

Training (mode "train") keeps float32 master parameters and casts each
layer's to ``cfg.dtype`` inside the layer's body, as the reference's
``_make_period_body`` does. ``cfg.remat == "block"`` runs each layer under
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
layer, so every kernel of it is launched twice a step; ``"none"`` keeps the
activations. ``"dots"`` is the reference's ``save_from_both_policies`` of
``dots_with_no_batch_dims_saveable`` and the MoE all-to-all's results: each
layer under the same checkpoint with a selective policy
(``create_selective_checkpoint_contexts``) that saves the outputs of
``aten.mm`` and ``aten.addmm`` (the products with no batch dims) and of the
MoE dispatch's exchanges (``collectives.all_to_all`` of kind ``"a2a"``,
the bucket all-to-all there and back, and ``collectives.EXCHANGE``, the
live-row counts, so the recompute sends nothing of the dispatch), and
recomputes the rest: ``bmm``, ``baddbmm``,
element-wise ops, the FSDP and TP gathers and sums, and the hand kernels
(``ctypes`` launches inside ``_Attention`` and ``_GroupedGemm``, no aten
op), as the reference recomputes its ``pallas_call``s and batched
einsums. The three modes keep different tensors and compute the same
values: losses and gradients are the same.

Across ranks (``sharding.use_rules`` with an executed profile on a
``(data, model)`` mesh), every entry point takes this rank's slab of a
global batch split over ``rules.batch`` and this rank's parameter slices
(``sharding.placement``). Under tensor parallelism (``default``,
``serve_tp``, ``ep_sharded``) the ranks of a ``model`` line hold the same
slab and split each layer's work (``tensor_parallel``; attention and the
mamba2 mixer by heads, the MLPs as Megatron pairs, the MoE by experts or
by sequence), so every rank of the line holds the whole loss. Where the
rules split a leaf over the FSDP axis (``data`` larger than 1), the slices
are gathered where they are used (``collectives.fsdp_gather``):

  * each layer's leaves inside the layer's body: float32 masters cast to
    the compute dtype before the gather, so the wire carries bf16 (the
    reference pins the cast to the FSDP sharding for the same reason).
    Under remat ``block`` the gather is inside the checkpointed body, so
    the backward's recompute gathers again and no rank keeps a whole layer
    between its forward and its backward; the gather's backward is a
    float32 reduce-scatter, which sums each slice's gradient over ``data``;
  * the tied embedding once a forward, in its own dtype (the cross entropy
    reads the float32 master, as the reference reads
    ``params["embed"].astype(float32)``), shared by the input lookup and
    the cross entropy; under ``ep_dp`` it is then this rank's vocab rows
    whole, and the vocab path below runs over ``model``.

Where the rules shard the tied embedding's vocab over the model axis as
a batch axis (``ep_dp``):

  * the input embedding gathers the token ids over the axis, looks up the
    rows this rank holds (zeros elsewhere) and reduce-scatters: each
    token's sum is its one nonzero row, exactly;
  * the cross entropy is vocab-parallel: each chunk's hidden states are
    gathered over the axis (the reference's ``batch_nm``), each rank
    scores them against its vocab columns, and the max, the sum of
    exponentials and the label's logit are reduced over the axis; every
    rank then holds the global loss, and the gather's backward (a
    reduce-scatter) brings each rank its slab's gradient;
  * the serving logits are the gathered last positions against the local
    columns, redistributed by an all-to-all to each rank's slab, full
    vocab.

Where they shard it over the ``tp`` axis (tensor parallelism), the line
already holds the same rows: the input lookup is each rank's rows summed
over the line (``psum``), the cross entropy scores each chunk of ``h``
(through ``tp_copy``) against the rank's vocab columns with the same three
reductions and no gather, and the logits are the ranks' columns joined
along the vocab.

Otherwise the cross entropy is each rank's own sum over the global label
count; with the vocab split the sums of the model line are reduced over
the batch axes the split leaves out (``data``). With no rules every path is
the one-process code.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..configs.base import ModelConfig
from ..core.collectives import (ALL_TO_ALL, EXCHANGE, all_gather_cat,
                                all_to_all, fsdp_gather, mesh_comm, psum,
                                reduce_scatter, tp_copy, tp_gather)
from ..core.device_common import resolve_device
from ..sharding.placement import param_specs, spec_axes
from ..sharding.rules import (_spec_for, check_executable, current_rules,
                              fsdp_dim, use_rules)
from .blocks import block_apply, block_cache_init, block_init
from .layers import compute_dtype, rmsnorm, rmsnorm_init, softcap, \
    trunc_normal

__all__ = ["init_params", "init_caches", "loss_fn", "train_logits",
           "prefill_step", "decode_step", "layer_kinds"]

REMAT = ("none", "block", "dots")
# what remat "dots" keeps: the products with no batch dims and the MoE
# dispatch's row counts; besides, the MoE's all-to-alls (kind "a2a")
DOTS_SAVED = frozenset((torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default, EXCHANGE))


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


def _vocab_split(cfg: ModelConfig):
    """(comm, axes, whether the axes split the batch too) when the rules
    in force shard the embedding's vocab, else None. The vocab axis is a
    batch axis under ``ep_dp`` / ``dp_only`` (its ranks hold other rows)
    and the ``tp`` axis under tensor parallelism (its ranks hold the same
    rows)."""
    rules = current_rules()
    if rules is None:
        return None
    axes = spec_axes(_spec_for("embed", (cfg.vocab, cfg.d_model), rules)[0])
    if rules.axis_size(axes[0] if axes else None) <= 1:
        return None
    return mesh_comm(rules.mesh), axes, any(a in rules.batch for a in axes)


def _batch_ranks(covered=()):
    """(comm, the batch axes of more than one rank, less ``covered``), or
    None when there are none."""
    rules = current_rules()
    if rules is None:
        return None
    axes = tuple(a for a in rules.batch
                 if a not in covered and rules.axis_size(a) > 1)
    return (mesh_comm(rules.mesh), axes) if axes else None


@functools.lru_cache(maxsize=None)
def _fsdp_dims(cfg: ModelConfig, rules) -> Dict[str, int]:
    """``{leaf path: dim}`` of the leaves ``rules`` split over the FSDP
    axis (empty without FSDP)."""
    if rules is None or rules.fsdp is None or rules.fsdp_size <= 1:
        return {}
    dims = ((path, fsdp_dim(spec, rules))
            for path, spec in param_specs(cfg, rules))
    return {path: d for path, d in dims if d is not None}


def _whole_embed(params, cfg: ModelConfig):
    """``params`` with the embedding gathered whole over the FSDP axis, in
    its own dtype, when the rules split it (once a forward: the input
    lookup and the cross entropy share it); else ``params``."""
    rules = current_rules()
    d = _fsdp_dims(cfg, rules).get("embed")
    if d is None:
        return params
    emb = params["embed"]
    whole, = fsdp_gather([emb], mesh_comm(rules.mesh), (rules.fsdp,), [d],
                         emb.dtype)
    return {**params, "embed": whole}


def _embed_input(params, cfg: ModelConfig, batch):
    check_executable(current_rules(), cfg)
    split = _vocab_split(cfg)
    if cfg.input_kind == "embeds":
        h = batch["embeds"]
    elif split:
        comm, axes, gathered = split
        emb = params["embed"]                             # (V/P, d)
        ids = batch["tokens"]
        if gathered:
            ids = comm.gather(ids, axes, "vocab")
            ids = ids.reshape((-1,) + tuple(ids.shape[2:]))
        ids = ids - comm.index(axes) * emb.shape[0]
        hit = (ids >= 0) & (ids < emb.shape[0])
        rows = emb[ids.clamp(0, emb.shape[0] - 1)]
        rows = torch.where(hit[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        # each token's one nonzero row: the line's sum (the same tokens on
        # every rank under tensor parallelism), or each rank's slab of it
        h = reduce_scatter(rows, comm, axes, "vocab") if gathered \
            else psum(rows, comm, axes, "vocab")
    else:
        h = params["embed"][batch["tokens"]]
    return h.to(compute_dtype(cfg.dtype))


def _vocab_logits(emb, cfg: ModelConfig, h, comm, axes):
    """(B_all, …, V/P) float32 logits of the gathered ``h`` against this
    rank's vocab rows ``emb``, and the first column's id."""
    logits = softcap(h.float() @ emb.float().T, cfg.logit_softcap)
    return logits, comm.index(axes) * emb.shape[0]


def _cast(tree, path: str, dtype, dims, split) -> dict:
    """``tree`` with float32 leaves cast to ``dtype``, other dtypes as they
    are; a leaf whose path is in ``dims`` is left out (None) and listed in
    ``split[its cast dtype]`` as ``(dict, key, slice, FSDP dim)``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _cast(v, f"{path}/{k}", dtype, dims, split)
            continue
        cast = dtype if v.dtype == torch.float32 else v.dtype
        if f"{path}/{k}" in dims:
            out[k] = None                       # gathered by the caller
            split.setdefault(cast, []).append(
                (out, k, v, dims[f"{path}/{k}"]))
        else:
            out[k] = v.to(cast)
    return out


def _layer_weights(lp, cfg: ModelConfig, layer: int):
    """Layer ``layer``'s weights for its body: float32 masters cast to the
    compute dtype (mixed precision, as the reference casts its float32
    master), other dtypes as they are; under FSDP the leaves the rules
    split over the FSDP axis cast, then gathered whole, in one transfer
    (:func:`fsdp_gather`)."""
    rules = current_rules()
    split: Dict[torch.dtype, list] = {}
    weights = _cast(lp, f"layers/{layer}", compute_dtype(cfg.dtype),
                    _fsdp_dims(cfg, rules), split)
    for cast, leaves in split.items():
        whole = fsdp_gather([v for _, _, v, _ in leaves],
                            mesh_comm(rules.mesh), (rules.fsdp,),
                            [d for _, _, _, d in leaves], cast)
        for (out, k, _, _), w in zip(leaves, whole):
            out[k] = w
    return weights


def _run_stack(params, cfg: ModelConfig, h, mode: str, caches):
    new_caches = []
    for i, (kind, lp, cache) in enumerate(zip(layer_kinds(cfg),
                                              params["layers"], caches)):
        h, nc, _ = block_apply(_layer_weights(lp, cfg, i), cfg, kind, h,
                               cache, mode)
        new_caches.append(nc)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), new_caches


def _train_layer(lp, cfg: ModelConfig, kind: str, layer: int, h,
                 rules=None):
    """One layer in mode "train" on its float32 master weights, cast (and
    under FSDP gathered) here, inside the checkpointed body, under
    ``rules``: the backward's recompute runs on autograd's device thread,
    which does not see the caller's thread-local rules."""
    with use_rules(rules):
        h, _, aux = block_apply(_layer_weights(lp, cfg, layer), cfg, kind,
                                h, None, "train")
    return h, aux


def _dots_policy(ctx, op, *args, **kwargs):
    save = op in DOTS_SAVED or (op is ALL_TO_ALL and args[-1] == "a2a")
    return CheckpointPolicy.MUST_SAVE if save \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _train_stack(params, cfg: ModelConfig, h) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    if cfg.remat not in REMAT:
        raise ValueError(f"remat {cfg.remat!r} is not one of {REMAT}")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (kind, lp) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        if cfg.remat != "none":
            h, a = checkpoint(_train_layer, lp, cfg, kind, i, h,
                              current_rules(), use_reentrant=False,
                              context_fn=_dots_context if cfg.remat == "dots"
                              else noop_context_fn)
        else:
            h, a = _train_layer(lp, cfg, kind, i, h, current_rules())
        aux = aux + a
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), aux


def train_logits(params, cfg: ModelConfig, batch):
    """Full float32 logits (B, S, vocab) against the tied embedding, and the
    MoE aux loss."""
    params = _whole_embed(params, cfg)
    h = _embed_input(params, cfg, batch)
    h, aux = _train_stack(params, cfg, h)
    split = _vocab_split(cfg)
    if split and not split[2]:
        comm, axes, _ = split
        logits, _ = _vocab_logits(params["embed"], cfg,
                                  tp_copy(h, comm, axes, "vocab"), comm,
                                  axes)
        return tp_gather(logits, comm, axes, logits.ndim - 1, "vocab"), aux
    if split:
        comm, axes, _ = split
        logits, _ = _vocab_logits(params["embed"], cfg,
                                  all_gather_cat(h, comm, axes, "vocab"),
                                  comm, axes)
        return all_to_all(logits, comm, axes, 0, logits.ndim - 1,
                          "vocab"), aux
    logits = h.float() @ params["embed"].float().T
    return softcap(logits, cfg.logit_softcap), aux


def _ce_chunk(hc, lc, embed_t, cfg: ModelConfig):
    """One sequence chunk's (sum of masked log p(label), count)."""
    logits = hc.float() @ embed_t.float()
    logits = softcap(logits, cfg.logit_softcap)
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    cols = torch.arange(logits.shape[-1], device=logits.device)
    label_logit = torch.sum(
        torch.where(cols == lc.clamp(min=0)[..., None], logits, 0.0), dim=-1)
    ll = label_logit - lse
    mask = (lc >= 0).float()
    return (ll * mask).sum(), mask.sum()


def _ce_chunk_vocab(hc, lc, emb, cfg: ModelConfig, comm, axes):
    """:func:`_ce_chunk` of the gathered chunk ``hc`` against this rank's
    vocab columns, the max, the sum of exponentials and the label's logit
    reduced over ``axes`` (the max without a gradient: the log-sum-exp
    does not depend on it)."""
    logits, v0 = _vocab_logits(emb, cfg, hc, comm, axes)
    m = comm.reduce(torch.amax(logits, dim=-1, keepdim=True).detach(), axes,
                    "max", "vocab")
    lse = torch.log(psum(torch.sum(torch.exp(logits - m), dim=-1), comm,
                         axes, "vocab")) + m[..., 0]
    cols = torch.arange(logits.shape[-1], device=logits.device) + v0
    label_logit = psum(torch.sum(
        torch.where(cols == lc.clamp(min=0)[..., None], logits, 0.0),
        dim=-1), comm, axes, "vocab")
    ll = label_logit - lse
    mask = (lc >= 0).float()
    return (ll * mask).sum(), mask.sum()


def _chunked_ce(params, cfg: ModelConfig, h, labels, n_chunks: int):
    """Cross entropy without materializing (B, S, vocab) logits.

    The reference's: the sequence in ``n_chunks`` chunks, each chunk's
    logits recomputed in the backward (its body under
    ``torch.utils.checkpoint``), so the peak holds one chunk's logits; the
    label's logit picked by a where over the vocab iota, as there. Labels
    below 0 are masked out.
    """
    s = h.shape[1]
    sc = s // n_chunks
    embed_t = params["embed"].T
    ce_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    split = _vocab_split(cfg)
    if split and split[2]:
        comm, axes, _ = split
        g = comm.gather(labels, axes, "vocab")
        labels = g.reshape((-1,) + tuple(g.shape[2:]))
    elif split:
        # the line holds the same h: each rank scores its vocab columns,
        # and the input operator sums h's gradient parts (once, not a
        # chunk at a time)
        comm, axes, _ = split
        h = tp_copy(h, comm, axes, "vocab")
    for i in range(n_chunks):
        part = slice(i * sc, (i + 1) * sc)
        if split:
            hc = all_gather_cat(h[:, part], comm, axes, "vocab") \
                if split[2] else h[:, part]
            ll, n = checkpoint(_ce_chunk_vocab, hc, labels[:, part],
                               params["embed"], cfg, comm, axes,
                               use_reentrant=False)
        else:
            ll, n = checkpoint(_ce_chunk, h[:, part], labels[:, part],
                               embed_t, cfg, use_reentrant=False)
        ce_sum, cnt = ce_sum - ll, cnt + n
    dp = _batch_ranks(split[1] if split else ())
    if dp:
        # this rank's (or its vocab line's) sum over the global count; the
        # psum's backward hands each rank the gradient of its own term
        ce_sum = psum(ce_sum, *dp)
        cnt = dp[0].reduce(cnt, dp[1], "sum", "reduce")
    return ce_sum / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch,
            loss_chunks: Optional[int] = None):
    """Next-token cross entropy + MoE aux. batch: tokens (or embeds) and
    ``labels`` (B, S). Returns (loss, metrics) with ``loss/ce``,
    ``loss/aux`` and ``loss/total``. ``loss_chunks`` None: the largest of
    16, 8, 4, 2 that divides S into chunks of at least 256 positions, else
    1 (the reference's rule)."""
    params = _whole_embed(params, cfg)
    h = _embed_input(params, cfg, batch)
    h, aux = _train_stack(params, cfg, h)
    labels = batch["labels"]
    s = labels.shape[1]
    if loss_chunks is None:
        loss_chunks = 1
        for c in (16, 8, 4, 2):
            if s % c == 0 and s // c >= 256:
                loss_chunks = c
                break
    ce = _chunked_ce(params, cfg, h, labels, loss_chunks)
    metrics = {"loss/ce": ce, "loss/aux": aux, "loss/total": ce + aux}
    return ce + aux, metrics


def _logits(params, cfg: ModelConfig, h):
    """Last-position logits in float32 against the tied embedding (this
    rank's slab, full vocab, under vocab-sharding rules)."""
    split = _vocab_split(cfg)
    if split and not split[2]:
        comm, axes, _ = split
        logits, _ = _vocab_logits(params["embed"], cfg, h[:, -1], comm, axes)
        g = comm.gather(logits, axes, "vocab")            # (P, B, V/P)
        return g.permute(1, 0, 2).reshape(g.shape[1], -1)
    if split:
        comm, axes, _ = split
        last = comm.gather(h[:, -1], axes, "vocab")
        logits, _ = _vocab_logits(params["embed"], cfg,
                                  last.reshape(-1, last.shape[-1]), comm,
                                  axes)
        p = comm.size(axes)
        return torch.cat(comm.exchange(list(logits.chunk(p)), axes, "vocab"),
                         dim=1)
    logits = h[:, -1].float() @ params["embed"].float().T
    return softcap(logits, cfg.logit_softcap)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda", dtype: torch.dtype = torch.bfloat16
                ) -> List[Any]:
    """One cache per layer: a bf16 KV cache for attention kinds, a float32
    ``SSMState`` (conv tail and SSM state) for mamba kinds. ``batch`` is
    this rank's slab. Under rules with a sequence-parallel axis of P ranks
    (``rules.sp``; ``launch.specs.cache_pspecs``) a KV cache holds this
    rank's block of ``max_len / P`` positions, or all of them where P does
    not divide ``max_len``; under a ``tp`` axis of P ranks that divides the
    mamba heads an ``SSMState`` holds this rank's heads (``cache_pspecs``),
    and its conv tail their x channels and B and C (the reference keeps the
    tail whole)."""
    dev = resolve_device(device)
    rules = current_rules()
    check_executable(rules, cfg)
    parts = rules.axis_size(rules.sp) if rules is not None else 1
    parts = parts if max_len % parts == 0 else 1
    tp = rules.axis_size(rules.tp) if rules is not None else 1
    heads = tp if cfg.ssm is not None \
        and cfg.ssm.n_heads(cfg.d_model) % tp == 0 else 1
    return [block_cache_init(cfg, kind, batch, max_len, device=dev,
                             dtype=dtype, seq_parts=parts, head_parts=heads)
            for kind in layer_kinds(cfg)]


def prefill_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 caches):
    """batch: ``{"tokens": (B, S)}`` (or ``"embeds"``); returns the last
    position's (B, vocab) float32 logits and the caches."""
    params = _whole_embed(params, cfg)
    h = _embed_input(params, cfg, batch)
    h, new_caches = _run_stack(params, cfg, h, "prefill", caches)
    return _logits(params, cfg, h), new_caches


def decode_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                caches):
    """batch: one token per sequence, ``{"tokens": (B, 1)}``; caches from
    prefill. Returns (B, vocab) float32 logits and the caches."""
    params = _whole_embed(params, cfg)
    h = _embed_input(params, cfg, batch)
    h, new_caches = _run_stack(params, cfg, h, "decode", caches)
    return _logits(params, cfg, h), new_caches
