"""Stand-ins for a step's inputs, and how they split over a mesh.

The port of ``repro.launch.specs``. A spec is a tuple per tensor, as in
``sharding.rules``. The port's caches are a list with one entry per layer
(no stacked period dim), so a cache spec has no leading ``None`` and a
``KVCache``'s ``length`` (a Python int) has the empty spec.

:func:`batch_pspecs` and :func:`cache_pspecs` give the specs.
:func:`batch_specs`, :func:`cache_specs` and :func:`state_specs` give the
step's inputs themselves as tensors that hold no memory, where the
reference gives ``ShapeDtypeStruct``s with ``NamedSharding``s: each leaf is
a :class:`Leaf`, this rank's slice (on the ``meta`` device, or a fake
tensor when built under ``FakeTensorMode`` with ``device="cpu"``, as the
dry-run builds them) with the global shape and the spec beside it.
:func:`tensors` takes the tensors out of such a tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.attention import KVCache
from ..models.mamba2 import SSMState
from ..sharding.rules import ShardingRules, leaf_pspecs, use_rules

__all__ = ["batch_pspecs", "cache_pspecs", "batch_specs", "cache_specs",
           "state_specs", "Leaf", "tensors"]


class Leaf:
    """One input of a step that holds no memory: ``tensor``, this rank's
    slice (its shape and dtype), and beside it the leaf's global ``shape``
    and ``spec``."""

    __slots__ = ("tensor", "shape", "spec")

    def __init__(self, tensor: torch.Tensor, shape, spec):
        self.tensor = tensor
        self.shape = tuple(shape)
        self.spec = tuple(spec)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    def __repr__(self) -> str:
        return (f"Leaf(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, local={tuple(self.tensor.shape)})")


def tensors(tree):
    """``tree`` with every :class:`Leaf` replaced by its tensor."""
    if isinstance(tree, Leaf):
        return tree.tensor
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tensors(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree


def _local_shape(shape, spec, rules: Optional[ShardingRules]) -> tuple:
    """This rank's block shape of a leaf of global ``shape`` under
    ``spec`` (every rank's block has it: the splits are even)."""
    if rules is None:
        return tuple(shape)
    out = []
    for d, entry in zip(shape, spec):
        axes = () if entry is None else \
            ((entry,) if isinstance(entry, str) else tuple(entry))
        out.append(d // math.prod(rules.axis_size(a) for a in axes))
    return tuple(out)


def _leaf(shape, dtype, spec, rules, device) -> Leaf:
    local = _local_shape(shape, spec, rules)
    return Leaf(torch.empty(local, dtype=dtype, device=device), shape, spec)


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


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                mesh=None, rules: Optional[ShardingRules] = None,
                device="meta") -> Dict[str, Leaf]:
    """The step's batch: int32 ``tokens`` (bf16 ``embeds`` for an
    embeddings model) of the global shape ``(global_batch, seq)`` (seq 1
    in decode) and, in training, int32 ``labels``; each this rank's slab
    under ``rules`` (the whole batch where the batch axes do not divide
    it, which the spec replicates and ``placement.batch_slab`` refuses)."""
    gb = shape.global_batch
    seq = shape.seq_len if shape.kind != "decode" else 1
    specs = batch_pspecs(cfg, shape, rules) if rules else None

    def leaf(name, dims, dtype):
        spec = specs[name] if specs else (None,) * len(dims)
        return _leaf(dims, dtype, spec, rules, device)

    out: Dict[str, Leaf] = {}
    if cfg.input_kind == "embeds":
        out["embeds"] = leaf("embeds", (gb, seq, cfg.d_model),
                             torch.bfloat16)
    else:
        out["tokens"] = leaf("tokens", (gb, seq), torch.int32)
    if shape.kind == "train":
        out["labels"] = leaf("labels", (gb, seq), torch.int32)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                mesh=None, rules: Optional[ShardingRules] = None,
                device="meta") -> List[Any]:
    """The decode caches of ``shape.seq_len`` positions for
    ``shape.global_batch`` sequences, one per layer, as
    ``models.init_caches`` makes them: under ``rules`` this rank's (its
    slab of the batch, its block of a KV cache's positions, its heads of an
    SSM state and the conv tail of those heads, which departs from the
    tail's whole spec: ``models.mamba2``). Each ``KVCache`` / ``SSMState``
    holds :class:`Leaf` tensors and its length 0 (the dry-run sets the
    decode step's position)."""
    from ..models.transformer import init_caches

    gb = shape.global_batch
    whole = init_caches(cfg, gb, shape.seq_len, device="meta")
    if rules is None:
        local, specs = whole, None
    else:
        b = gb // rules.batch_size if gb % max(rules.batch_size, 1) == 0 \
            else gb
        with use_rules(rules):
            local = init_caches(cfg, b, shape.seq_len, device="meta")
        specs = cache_pspecs(cfg, shape, rules)
    out = []
    for i, (w, c) in enumerate(zip(whole, local)):
        spec = specs[i] if specs else None

        def leaf(name):
            t = getattr(c, name)
            s = getattr(spec, name) if spec else (None,) * t.ndim
            return Leaf(torch.empty(t.shape, dtype=t.dtype, device=device),
                        getattr(w, name).shape, s)

        if isinstance(c, KVCache):
            out.append(c._replace(k=leaf("k"), v=leaf("v")))
        else:
            out.append(SSMState(conv=leaf("conv"), ssm=leaf("ssm")))
    return out


def state_specs(cfg: ModelConfig, mesh=None,
                rules: Optional[ShardingRules] = None,
                with_opt: bool = True, compress: bool = False,
                device="meta"):
    """The parameters (``with_opt=False``) or the whole ``TrainState``:
    ``cfg.param_dtype`` parameters and, with the optimizer, float32 AdamW
    moments, the int32 step and, with ``compress``, the float32 int8
    error-feedback residual, leaf for leaf as ``train.init_train_state``
    builds them on ``sharding.placement.init_params_sharded``'s slices.
    Each leaf's spec comes from its path and global shape
    (``sharding.rules``); the moments and the residual take their
    parameter's, the step the empty spec."""
    from ..sharding.placement import global_params
    from ..train.optimizer import OptState, tree_map
    from ..train.step import TrainState

    dtype = getattr(torch, cfg.param_dtype)
    whole = global_params(cfg, dtype)
    specs = iter([spec for _, spec in leaf_pspecs(whole, rules)]
                 if rules else [])
    params = tree_map(lambda w: _leaf(
        w.shape, w.dtype, next(specs) if rules else (None,) * w.ndim, rules,
        device), whole)
    if not with_opt:
        return params

    def like(p, dt=torch.float32):
        return Leaf(torch.empty(p.tensor.shape, dtype=dt, device=device),
                    p.shape, p.spec)

    opt = OptState(mu=tree_map(like, params), nu=tree_map(like, params),
                   step=Leaf(torch.empty((), dtype=torch.int32,
                                         device=device), (), ()))
    residual = tree_map(like, params) if compress else None
    return TrainState(params=params, opt=opt, residual=residual)

