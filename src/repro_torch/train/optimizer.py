"""Hand-rolled AdamW + schedules + gradient clipping + compression.

The port's ``repro.train.optimizer``: the same update in the same order of
operations, on float32 tensors on the parameters' own device. Parameter
trees are nested dicts, lists and tuples of tensors; :func:`tree_leaves`
walks them in the reference's order (dict keys sorted, sequences in order).

:func:`adamw_update` updates the parameters and both moments **in place**
and returns them: the reference builds a new tree, but at the training
path's size (2.7 B float32 parameters, 16 bytes each with their gradient and
two moments) a second copy of the state does not fit beside the first on
one 80 GB card. A failure inside the update leaves the state partly
updated; the train loop goes back to its last checkpoint then.

Gradient compression (int8 with error feedback): :func:`compress_int8`
quantizes a gradient per tensor and carries the quantization error to the
next step in a residual buffer (the EF-SGD family).

Across ranks a leaf may be this rank's slice of a whole one
(``sharding.placement``): ``sharded`` (a ``MeshComm`` and each leaf's
shard axes) makes the global norm sum each sliced leaf's squares over its
axes, and ``reduce_max`` makes the int8 scale the max over the whole leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "clip_by_global_norm", "compress_int8",
           "decompress_int8", "tree_leaves", "tree_map"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts, lists and tuples, dict keys in sorted
    order (``jax.tree_util``'s order); ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``tree`` with each leaf ``x`` replaced by ``fn(x)``, ``fn`` called in
    :func:`tree_leaves`' order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):          # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    mu: Any               # first moment (params-shaped, float32)
    nu: Any               # second moment
    step: torch.Tensor    # () int32


def adamw_init(params) -> OptState:
    """Zero float32 moments beside each parameter, step 0 (int32) on the
    first parameter's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then cosine decay to 0 at
    ``total_steps``; a float32 0-d tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def _global_norm(grads, sharded=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's sum of
    squares in float32. ``sharded``: ``(comm, [axes of each leaf])`` —
    the squares of leaves sliced over axes are summed over those ranks."""
    total = 0
    over: dict = {}
    axes = sharded[1] if sharded else None
    for i, g in enumerate(tree_leaves(grads)):
        sq = torch.sum(torch.square(g.float()))
        if axes and axes[i]:
            over[axes[i]] = over.get(axes[i], 0) + sq
        else:
            total = total + sq
    for ax, sq in over.items():
        total = total + sharded[0].reduce(sq, ax, "sum", "reduce")
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global norm is at most ``max_norm``,
    the norm before scaling)."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState,
                 sharded=None) -> Tuple[Any, OptState, dict]:
    """One AdamW step with global-norm clipping and the cosine schedule.

    Updates ``params``, ``state.mu`` and ``state.nu`` in place (see the
    module docstring) and returns ``(params, OptState(mu, nu, step + 1),
    {"opt/grad_norm", "opt/lr"})``. Each gradient is clipped as
    :func:`clip_by_global_norm` clips it, one leaf at a time, so no second
    copy of the gradients is held. ``sharded``: as for
    :func:`_global_norm`.
    """
    gnorm = _global_norm(grads, sharded)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        gf = (g * scale).float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        mhat = m / b1c
        vhat = v / b2c
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step_)
    return params, OptState(state.mu, state.nu, step), \
        {"opt/grad_norm": gnorm, "opt/lr": lr}


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------

def compress_int8(g: torch.Tensor, residual: torch.Tensor,
                  reduce_max: Callable = None):
    """Per-tensor symmetric int8 quantization; returns (q, scale, new_res).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    ``reduce_max``: the max of a slice's largest |value| over the ranks
    holding the leaf's other slices (a NaN on any of them kept, as
    ``jnp.max`` keeps it)."""
    gf = g.float() + residual
    amax = torch.max(torch.abs(gf))
    if reduce_max is not None:
        amax = reduce_max(amax)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_res = gf - q.float() * scale
    return q, scale, new_res


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
