"""How a global batch and its decode caches split over a mesh.

The two spec functions of ``repro.launch.specs`` that the port executes
with: :func:`batch_pspecs` and :func:`cache_pspecs`. A spec is a tuple per
tensor, as in ``sharding.rules``. The port's caches are a list with one
entry per layer (no stacked period dim), so a cache spec has no leading
``None`` and a ``KVCache``'s ``length`` (a Python int) has the empty spec.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..configs.base import ModelConfig, ShapeConfig
from ..models.attention import KVCache
from ..models.mamba2 import SSMState
from ..sharding.rules import ShardingRules

__all__ = ["batch_pspecs", "cache_pspecs"]


def _batch_axis(shape: ShapeConfig, rules: ShardingRules) -> Any:
    # batch sharded over the batch axes when divisible, else replicated
    # (long_500k has global_batch=1: model+sequence parallelism only)
    divisible = rules.batch and \
        shape.global_batch % max(rules.batch_size, 1) == 0
    if not divisible:
        return None
    # one axis is named alone, as a PartitionSpec normalizes it
    return rules.batch[0] if len(rules.batch) == 1 else rules.batch


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig,
                 rules: ShardingRules) -> Dict[str, tuple]:
    batch_ax = _batch_axis(shape, rules)
    out = {}
    if cfg.input_kind == "embeds":
        out["embeds"] = (batch_ax, None, None)
    else:
        out["tokens"] = (batch_ax, None)
    if shape.kind == "train":
        out["labels"] = (batch_ax, None)
    return out


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig,
                 rules: ShardingRules) -> List[Any]:
    """Per layer: KV caches with batch over the batch axes and *sequence
    over model* (SP); mamba states with batch over the batch axes and
    heads over model when divisible. These are the reference's specs; the
    port's conv tail departs from its whole spec and holds the rank's
    heads' x channels and B and C (``models.mamba2``)."""
    batch_ax = _batch_axis(shape, rules)

    def per_kind(kind: str):
        if kind in "aAl":
            return KVCache(k=(batch_ax, rules.sp, None, None),
                           v=(batch_ax, rules.sp, None, None),
                           length=())
        nh = cfg.ssm.n_heads(cfg.d_model)
        head_ax = rules.tp if nh % max(rules.tp_size, 1) == 0 else None
        return SSMState(conv=(batch_ax, None, None),
                        ssm=(batch_ax, head_ax, None, None))

    return [per_kind(cfg.pattern[i % len(cfg.pattern)])
            for i in range(cfg.n_layers)]
