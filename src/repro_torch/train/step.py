"""train_step / serve_step builders — the port of ``repro.train.step``.

``make_train_step`` closes over (cfg, opt_cfg) and returns
``(state, batch) -> (state, metrics)``: the loss and its gradient by
autograd through the model's kernels (the device decides: a card launches
them, the CPU runs their plain versions), gradient accumulation over
``microbatches``, optional int8 gradient compression with error feedback,
and the AdamW update. The reference jits this function; here it runs
eagerly, and the update is in place (``optimizer.adamw_update``): the
returned state holds the given state's tensors, updated.

Gradient compression quantizes each gradient to int8 and dequantizes it on
the same device, as the reference does on one host (there the int8 tensors
are what a data-parallel all-reduce would move); the quantization error is
carried to the next step in ``state.residual``.

Under ``sharding.use_rules`` (an executed profile, each rank holding its
slab of the batch and its slices of the state) each rank's loss is its
share of the global one, so a leaf's gradient is summed over the batch
ranks that do not split it: a replicated leaf's over all of them, while an
expert or vocab slice's gradient is whole already (the all-to-all's and
the gather's backward deliver every rank's contribution to its owner), and
an FSDP slice's sum over ``data`` is the float32 reduce-scatter of its
gather's backward (``collectives.fsdp_gather``), leaving the other batch
axes (``model`` under ``ep_dp`` / ``dp_only``) to the sum here. Under
tensor parallelism ``model`` is no batch axis: the ranks of a line hold
the same slab and the whole loss, a leaf split over ``model`` has its
whole gradient on its rank, and a leaf replicated there the same gradient
on each (the model's ``tp_copy`` sums the parts), which is not summed.
Then, as the reference quantizes the reduced gradient, each leaf is
compressed with its scale the max over the whole leaf, the residual
sliced like its leaf, and the global norm sums the slices' squares.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..core.collectives import mesh_comm
from ..models.transformer import decode_step, loss_fn, prefill_step
from ..sharding.placement import param_specs, spec_axes
from ..sharding.rules import check_executable, current_rules
from .optimizer import (AdamWConfig, OptState, adamw_init, adamw_update,
                        compress_int8, decompress_int8, tree_leaves,
                        tree_map)

__all__ = ["TrainState", "make_train_step", "make_eval_step",
           "make_prefill_step", "make_decode_step", "init_train_state"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    residual: Optional[Any]    # error-feedback buffers (grad compression)


def init_train_state(cfg: ModelConfig, params,
                     compress: bool = False) -> TrainState:
    """AdamW's zero moments, and float32 zero residuals when
    ``compress``."""
    residual = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params) \
        if compress else None
    return TrainState(params=params, opt=adamw_init(params),
                      residual=residual)


def _grads(cfg: ModelConfig, params, batch):
    """(gradient leaves in tree order, detached metrics) of ``loss_fn``.
    A leaf the loss does not use (``norm_ffn`` of a block without an FFN,
    d_ff 0) gets a zero gradient, as ``jax.grad`` gives it."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(tracked, cfg, batch)
    grads = torch.autograd.grad(loss, tree_leaves(tracked),
                                materialize_grads=True)
    return list(grads), {k: v.detach() for k, v in metrics.items()}


def _rank_plan(cfg: ModelConfig, rules):
    """(comm, per leaf: the axes it is sliced over, the batch axes its
    gradient is summed over), leaves in tree order."""
    comm = mesh_comm(rules.mesh)
    split, summed = [], []
    for _, spec in param_specs(cfg, rules):
        axes = tuple(a for e in spec for a in spec_axes(e)
                     if rules.axis_size(a) > 1)
        split.append(axes)
        summed.append(tuple(a for a in rules.batch if a not in axes
                            and rules.axis_size(a) > 1))
    return comm, split, summed


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    compress_grads: bool = False,
                    microbatches: int = 1) -> Callable:
    """``microbatches > 1`` = gradient accumulation: the batch is split
    along its first dim and each part's gradient computed in turn (its
    backward ends before the next forward starts), summed in float32 and
    divided by the count; each metric is the mean over the parts."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    plans: dict = {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        rules = current_rules()
        check_executable(rules, cfg)
        if microbatches > 1:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"{microbatches} microbatches do not divide "
                                 f"a batch of {b}")
            n = b // microbatches
            grads, per_mb = None, []
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, metrics = _grads(cfg, state.params, mb)
                if grads is None:
                    grads = [torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device) for x in g]
                for acc, x in zip(grads, g):
                    acc.add_(x)
                per_mb.append(metrics)
                del g
            grads = [g / microbatches for g in grads]
            metrics = {k: torch.stack([m[k] for m in per_mb]).float().mean()
                       for k in per_mb[0]}
        else:
            grads, metrics = _grads(cfg, state.params, batch)

        sharded = None
        split = [()] * len(grads)
        if rules is not None:
            if rules not in plans:
                plans[rules] = _rank_plan(cfg, rules)
            comm, split, summed = plans[rules]
            grads = [comm.reduce(g, ax, "sum", "reduce") if ax else g
                     for g, ax in zip(grads, summed)]
            sharded = (comm, split)

        if compress_grads:
            if state.residual is None:
                raise ValueError("compress_grads needs a state made with "
                                 "init_train_state(..., compress=True)")
            for i, r in enumerate(tree_leaves(state.residual)):
                over = None if not split[i] else (
                    lambda m, ax=split[i]: sharded[0].reduce(
                        m, ax, "max", "reduce"))
                q, s, new_r = compress_int8(grads[i], r, over)
                grads[i] = decompress_int8(q, s)
                r.copy_(new_r)

        it = iter(grads)
        grad_tree = tree_map(lambda _: next(it), state.params)
        del grads
        params, opt, opt_metrics = adamw_update(
            opt_cfg, state.params, grad_tree, state.opt, sharded)
        return TrainState(params, opt, state.residual), \
            {**metrics, **opt_metrics}

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, cfg, batch)
        return metrics

    return eval_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def step(params, batch, caches):
        return prefill_step(params, cfg, batch, caches)

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def step(params, batch, caches):
        return decode_step(params, cfg, batch, caches)

    return step
