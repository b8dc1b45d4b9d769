"""Logical-axis sharding rules: name-based partition specs (MaxText-style).

The port of ``repro.sharding.rules``. Parallelism scheme over the
production meshes ``(data=16, model=16)`` / ``(pod=2, data=16, model=16)``:

  * DP/FSDP — batch over ``(pod, data)``; parameters ZeRO-sharded over
    ``data`` on their largest non-TP dimension.
  * TP — Megatron pairs: Q/K/V & up-projections column-sharded over
    ``model``, output & down-projections row-sharded.
  * EP — MoE expert dim over ``model`` (experts padded to a multiple).
  * SP — long-context KV caches sequence-sharded over ``model``.

A spec is a tuple with one entry per dim: ``None`` (whole), an axis name,
or a tuple of axis names (the dim split over their product, in C order).
The mesh is a ``torch.distributed`` ``DeviceMesh`` or any object with the
mesh's dim names (``mesh_dim_names`` or ``axis_names``) and sizes
(``mesh.shape`` as a mapping or a tuple), so production shapes resolve
without a 256-rank world.

Entry points:

  * :func:`param_pspecs` — a parameter tree's specs by leaf *path name*
    (the rules table below). Paths are the port's own: ``embed``,
    ``layers/<i>/moe/experts_up``, … The port stacks no layers, so no
    leading ``None`` is added for a scan dim.
  * :func:`shard` — the reference's activation constraint; the identity
    here (see its docstring).
  * :func:`check_executable` — what the port executes across ranks:
    every profile on any mesh for every block kind, FSDP over ``data``
    included; it refuses attention whose projections the ``tp`` line does
    not divide.
  * :func:`fsdp_dim` — the dim of a leaf split over the FSDP axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Dict, Optional, Tuple

__all__ = [
    "AXIS_POD", "AXIS_DATA", "AXIS_MODEL",
    "ShardingRules", "use_rules", "current_rules", "shard", "param_pspecs",
    "mesh_sizes", "check_executable", "leaf_pspecs", "fsdp_dim",
]

AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_MODEL = "model"


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` or a stand-in, in the
    mesh's dim order."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, dict) or hasattr(shape, "keys"):
        return {n: int(shape[n]) for n in names}
    return {n: int(s) for n, s in zip(names, tuple(shape))}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved logical axes for one mesh."""

    batch: Tuple[str, ...]           # ('pod', 'data') or ('data',)
    fsdp: Optional[str] = AXIS_DATA  # ZeRO shard axis for params
    tp: Optional[str] = AXIS_MODEL   # tensor-parallel axis
    sp: Optional[str] = AXIS_MODEL   # sequence-parallel axis (KV caches)
    # divisibility context for conditional activation shardings
    tp_size: int = 1
    fsdp_size: int = 1
    batch_size: int = 1              # product of batch mesh axes
    # explicit expert-parallel dispatch (the paper's Algorithm 1 with a
    # hand-placed all-to-all)
    ep_shard_map: bool = False
    ep_axis: Optional[str] = None    # expert-shard axis (defaults to tp)
    mesh: Optional[object] = dataclasses.field(
        default=None, compare=False, hash=False)

    @property
    def expert_axis(self) -> Optional[str]:
        return self.ep_axis or self.tp

    def axis_size(self, axis: Optional[str]) -> int:
        """The mesh size of ``axis`` (1 for None or without a mesh)."""
        if axis is None or self.mesh is None:
            return 1
        return mesh_sizes(self.mesh)[axis]

    @staticmethod
    def for_mesh(mesh, profile: str = "default") -> "ShardingRules":
        """Resolve a parallelism *profile* onto a mesh.

        default   : DP over (pod, data) + FSDP over data + TP/EP/SP over
                    model — the safe starting point for every cell.
        dp_only   : no tensor parallelism; the model axis joins data
                    parallelism (batch over pod×data×model, params FSDP
                    over data).
        serve_tp  : inference profile — no FSDP, params sharded over model
                    only, batch over (pod, data), KV caches
                    sequence-sharded.
        ep_sharded: like default, but MoE dispatch/combine runs as an
                    explicit all-to-all.
        ep_dp     : expert parallelism WITHOUT tensor parallelism — batch
                    over pod×data×model, experts sharded over 'model' with
                    the explicit all-to-all. The right shape for small-d
                    MoEs (qwen2-moe d=2048).
        """
        sizes = mesh_sizes(mesh)
        names = tuple(sizes)
        has_model = AXIS_MODEL in names
        ep = False
        ep_axis = None
        if profile in ("default", "ep_sharded"):
            ep = profile == "ep_sharded"
            batch = tuple(n for n in (AXIS_POD, AXIS_DATA) if n in names)
            fsdp = AXIS_DATA if AXIS_DATA in names else None
            tp = AXIS_MODEL if has_model else None
        elif profile == "ep_dp":
            ep = True
            ep_axis = AXIS_MODEL if has_model else None
            batch = tuple(n for n in (AXIS_POD, AXIS_DATA, AXIS_MODEL)
                          if n in names)
            fsdp = AXIS_DATA if AXIS_DATA in names else None
            tp = None
        elif profile == "dp_only":
            batch = tuple(n for n in (AXIS_POD, AXIS_DATA, AXIS_MODEL)
                          if n in names)
            fsdp = AXIS_DATA if AXIS_DATA in names else None
            tp = None
        elif profile == "serve_tp":
            batch = tuple(n for n in (AXIS_POD, AXIS_DATA) if n in names)
            fsdp = None
            tp = AXIS_MODEL if has_model else None
        else:
            raise ValueError(f"unknown profile {profile!r}")
        bsz = 1
        for n in batch:
            bsz *= sizes[n]
        return ShardingRules(
            batch=batch, fsdp=fsdp, tp=tp, sp=tp,
            tp_size=sizes[AXIS_MODEL] if tp else 1,
            fsdp_size=sizes[AXIS_DATA] if fsdp else 1,
            batch_size=bsz,
            ep_shard_map=ep, ep_axis=ep_axis, mesh=mesh,
        )


_ctx = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = current_rules()
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def shard(x, *logical: Optional[str]):
    """The reference's activation constraint, which returns ``x``
    unchanged here.

    In the reference it tells GSPMD how to partition an activation of one
    global program. In the port each rank already holds its own slab of
    every activation, and the model code moves data between ranks
    explicitly (``core.collectives``), so there is no partitioner to
    constrain.
    """
    return x


def check_executable(rules: Optional[ShardingRules], cfg=None) -> None:
    """Raise ``NotImplementedError`` unless the port executes ``rules``
    across ranks for ``cfg``'s layers. Every profile executes on any mesh:
    FSDP over a ``data`` axis of any size (each leaf's slices gathered
    where the model uses them, ``models.transformer``), and the tensor-
    and sequence-parallel profiles (``default``, ``serve_tp``,
    ``ep_sharded``) for every block kind: attention (``a``, ``A``, ``l``)
    by heads, mamba2 (``m``, ``M``) by heads where the line divides them
    and whole on every rank where it does not (``models.mamba2``). One
    split is refused: attention under a ``tp`` line that does not divide
    its q/k/v projections' columns, which the rules would leave whole and
    which the port splits only by heads or head columns."""
    if rules is None or rules.tp is None or cfg is None:
        return
    p = rules.tp_size
    if any(k in "aAl" for k in cfg.pattern) and (
            (cfg.n_heads * cfg.hd) % p or (cfg.n_kv_heads * cfg.hd) % p):
        raise NotImplementedError(
            f"{cfg.name}: a tp line of {p} does not divide the attention "
            "projections' columns, which the rules would leave whole")


def fsdp_dim(spec, rules: ShardingRules) -> Optional[int]:
    """The dim of a leaf with ``spec`` that is split over ``rules.fsdp``
    (an axis of more than one rank), or None: the leaf is whole along that
    axis (no ``"fsdp"`` in its rule, or a dim the axis does not divide,
    which ``_spec_for`` leaves whole)."""
    if rules.fsdp is None or rules.fsdp_size <= 1:
        return None
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if rules.fsdp in axes:
            return d
    return None


# ---------------------------------------------------------------------------
# parameter rules — matched against the leaf's path (joined with '/')
# ---------------------------------------------------------------------------
# Conventions (see models/): projections stored flat —
#   wq/wk/wv : (d_model, H*hd)      col-sharded (fsdp, tp)
#   wo       : (H*hd, d_model)      row-sharded (tp, fsdp)
#   w_up/w_gate : (d_model, d_ff)   col-sharded (fsdp, tp)
#   w_down   : (d_ff, d_model)      row-sharded (tp, fsdp)
#   embed    : (vocab, d_model)     vocab over tp (sharded logits/softmax)
#   experts_*: (E, ...)             expert dim over tp (EP)
#   mamba in/out projections        like mlp

_RULES = [
    (r"embed$",                     ("vocab", "fsdp")),
    (r"(wq|wk|wv|wqkv)$",           ("fsdp", "tp")),
    (r"wo$",                        ("tp", "fsdp")),
    (r"(w_up|w_gate|w_in)$",        ("fsdp", "tp")),
    (r"w_down|w_out$",              ("tp", "fsdp")),
    (r"experts_up$",                ("ep", None, None)),
    (r"experts_gate$",              ("ep", None, None)),
    (r"experts_down$",              ("ep", None, None)),
    (r"router$",                    ("fsdp", None)),
    (r"(a_log|dt_bias|d_skip)$",    (None,)),
    (r"conv_w$",                    (None, "tp")),
    (r"(norm|scale|bias|qnorm|knorm)", (None,)),
]


def _spec_for(path: str, shape, rules: ShardingRules) -> tuple:
    ndim = len(shape)
    for pat, logical in _RULES:
        if re.search(pat, path):
            resolved = []
            for name in logical:
                if name == "tp":
                    resolved.append((rules.tp, rules.tp_size))
                elif name in ("vocab", "ep"):
                    # vocab shards over tp when active, else the expert /
                    # model axis (keeps the big embedding + CE sharded
                    # under ep_dp / dp_only too)
                    ax = (rules.tp or rules.expert_axis) if name == "vocab" \
                        else rules.expert_axis
                    sz = rules.axis_size(ax) \
                        if (ax and rules.mesh is not None) else rules.tp_size
                    resolved.append((ax, sz))
                elif name == "fsdp":
                    resolved.append((rules.fsdp, rules.fsdp_size))
                else:
                    resolved.append((None, 1))
            while len(resolved) < ndim:
                resolved.insert(0, (None, 1))
            resolved = resolved[-ndim:] if ndim else []
            # drop axes whose dim is not divisible by the axis size
            # (e.g. mamba2's 50280-row vocab on a 16-way model axis)
            return tuple(ax if ax and d % max(sz, 1) == 0 else None
                         for (ax, sz), d in zip(resolved, shape))
    return (None,) * ndim


def leaf_pspecs(params, rules: ShardingRules):
    """``[(path, spec)]`` of ``params``' leaves in tree order, each spec
    from the leaf's path (its checkpoint key) and its *global* shape
    (``leaf.shape``)."""
    from ..checkpoint.store import _leaves

    return [(path, _spec_for(path, tuple(leaf.shape), rules))
            for path, leaf in _leaves(params)]


def param_pspecs(params, rules: ShardingRules):
    """A tree mirroring ``params`` with each leaf's spec in its place."""
    from ..train.optimizer import tree_map

    specs = iter([s for _, s in leaf_pspecs(params, rules)])
    return tree_map(lambda _: next(specs), params)
