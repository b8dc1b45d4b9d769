"""Where each leaf lives across ranks: this rank's slice, the gather back,
a sharded init and a batch's slab.

A leaf's spec (``rules.param_pspecs``) names, per dim, the mesh axes it is
split over; this rank holds the block at its coordinate on those axes
(C order over a tuple of axes). Specs come from a leaf's *global* shape,
so the port computes them from :func:`global_params` (the model's tree on
the ``meta`` device, no storage) and never from a slice.

:func:`init_params_sharded` draws every leaf whole on the device from the
caller's generator, in ``init_params``' order, and keeps only this rank's
slice of it before the next leaf is drawn: every rank's weights are the
one-process model's slices, and no rank ever holds the whole model.
:func:`place` slices a whole tree (``models.convert.params_from_reference``
passes the JAX package's arrays through it), :func:`gather_full` gathers a
slice back into its whole leaf, and :class:`NamedSharding` is what
``checkpoint.restore_checkpoint(sharding_tree=...)`` slices a restored leaf
with.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.store import _leaves
from .rules import ShardingRules, check_executable, leaf_pspecs, mesh_sizes

__all__ = ["coordinate", "spec_axes", "local_slice", "gather_full", "place",
           "global_params", "param_specs", "init_params_sharded",
           "batch_slab", "NamedSharding", "named_shardings"]


def coordinate(rules: ShardingRules) -> Dict[str, int]:
    """This rank's index along each mesh dim: from a ``DeviceMesh``'s
    ``get_coordinate()``, or a stand-in mesh's ``coordinate``."""
    mesh = rules.mesh
    names = list(mesh_sizes(mesh))
    coord = mesh.get_coordinate() if hasattr(mesh, "get_coordinate") \
        else mesh.coordinate
    if coord is None:
        raise ValueError("this rank is not a member of the mesh")
    if isinstance(coord, dict):
        return {n: int(coord[n]) for n in names}
    return {n: int(c) for n, c in zip(names, coord)}


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``()`` for a whole dim)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _part(entry, rules: ShardingRules, coord) -> Tuple[int, int]:
    """(this rank's block, block count) of a dim split over ``entry``."""
    idx, count = 0, 1
    for ax in spec_axes(entry):
        n = rules.axis_size(ax)
        idx, count = idx * n + coord[ax], count * n
    return idx, count


def local_slice(x, spec, rules: ShardingRules, coord=None):
    """This rank's block of the whole leaf ``x`` (tensor or numpy) under
    ``spec``: a view, or ``x`` itself when the spec splits nothing."""
    coord = coordinate(rules) if coord is None else coord
    for d, entry in enumerate(spec):
        i, n = _part(entry, rules, coord)
        if n > 1:
            size = x.shape[d] // n
            sl = [slice(None)] * x.ndim
            sl[d] = slice(i * size, (i + 1) * size)
            x = x[tuple(sl)]
    return x


def _owned(t: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``t`` in storage of its own when it is a view into ``whole``."""
    return t.clone() if t is not whole else t


def _assemble(slices, spec, rules: ShardingRules, axes, coord):
    """The whole leaf from the member slices of a gather over ``axes``
    (member order: C order over the mesh dims among ``axes``)."""
    sizes = mesh_sizes(rules.mesh)
    names = [n for n in sizes if n in axes]
    x = slices[0]
    shape = list(x.shape)
    for d, entry in enumerate(spec):
        shape[d] *= _part(entry, rules, coord)[1]
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    for i, piece in enumerate(slices):
        at = dict(coord)
        at.update(zip(names, np.unravel_index(i, [sizes[n] for n in names])))
        sl = []
        for d, entry in enumerate(spec):
            j, _ = _part(entry, rules, at)
            sl.append(slice(j * piece.shape[d], (j + 1) * piece.shape[d]))
        out[tuple(sl)] = piece
    return out


def gather_full(x: torch.Tensor, spec, rules: ShardingRules,
                root: int = 0) -> Optional[torch.Tensor]:
    """The whole leaf from every rank's slice ``x``, on global rank
    ``root`` (None on the others; every rank holding a slice calls it).
    Only the ranks of ``root``'s line over the leaf's axes send: on the
    other lines (a leaf split over ``data`` is replicated over ``model``)
    the same slices are replicas, and those ranks move nothing."""
    from ..core.collectives import mesh_comm

    axes = [a for e in spec for a in spec_axes(e) if rules.axis_size(a) > 1]
    if not axes:
        return x
    comm = mesh_comm(rules.mesh)
    if root not in comm.ranks(axes):
        return None
    slices = comm.gather_to(x, axes, root, "reduce")
    if slices is None:
        return None
    return _assemble(slices, spec, rules, axes, coordinate(rules))


def place(tree, rules: ShardingRules):
    """Every leaf of the whole tree ``tree`` (tensors or numpy arrays) cut
    to this rank's slice, in storage of its own."""
    from ..train.optimizer import tree_map

    specs = iter([spec for _, spec in leaf_pspecs(tree, rules)])
    coord = coordinate(rules)

    def cut(leaf):
        s = local_slice(leaf, next(specs), rules, coord)
        if s is leaf:
            return leaf
        return s.clone() if isinstance(s, torch.Tensor) \
            else np.ascontiguousarray(s)

    return tree_map(cut, tree)


def global_params(cfg, dtype: torch.dtype = torch.bfloat16):
    """The whole model's parameter tree on the ``meta`` device (shapes and
    dtypes, no storage)."""
    from ..models.transformer import init_params

    return init_params(cfg, torch.Generator(), device="meta", dtype=dtype)


def param_specs(cfg, rules: ShardingRules) -> List[Tuple[str, tuple]]:
    """``[(path, spec)]`` of the model's parameters in tree order."""
    return leaf_pspecs(global_params(cfg), rules)


def init_params_sharded(cfg, rules: ShardingRules,
                        generator: Optional[torch.Generator] = None,
                        device="cuda", dtype: torch.dtype = torch.bfloat16):
    """This rank's slices of ``init_params(cfg, generator, device, dtype)``.

    The leaves are drawn as ``init_params`` draws them, each whole, and
    each is cut to this rank's slice (in storage of its own) before the
    next is drawn; leaves that are not drawn (norm scales, mamba's
    constants) are cut after the tree is built. A dry run on the ``meta``
    device gives each draw's path."""
    from ..core.device_common import resolve_device
    from ..models.layers import on_draw
    from ..models.transformer import init_params
    from ..train.optimizer import tree_map

    check_executable(rules, cfg)
    dev = resolve_device(device)
    drawn: List[torch.Tensor] = []
    with on_draw(lambda t: drawn.append(t) or t):
        meta = init_params(cfg, torch.Generator(), device="meta", dtype=dtype)
    path_of = {id(leaf): path for path, leaf in _leaves(meta)}
    specs = dict(leaf_pspecs(meta, rules))
    order = [path_of.get(id(t)) for t in drawn]
    coord = coordinate(rules)
    it = iter(order)

    def keep(t):
        path = next(it)
        if path is None:
            return t
        return _owned(local_slice(t, specs[path], rules, coord), t)

    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with on_draw(keep):
        params = init_params(cfg, generator, device=dev, dtype=dtype)
    shapes = iter([tuple(leaf.shape) for _, leaf in _leaves(meta)])
    paths = iter([path for path, _ in _leaves(meta)])

    def cut_whole(leaf):
        path, whole = next(paths), tuple(leaf.shape) == next(shapes)
        return _owned(local_slice(leaf, specs[path], rules, coord), leaf) \
            if whole else leaf

    return tree_map(cut_whole, params)


def batch_slab(x, rules: ShardingRules):
    """This rank's slab of a global batch tensor: dim 0 split over
    ``rules.batch``. A batch the axes do not divide would be replicated
    (``launch.specs.batch_pspecs``), which the port does not execute:
    ``NotImplementedError``."""
    if x.shape[0] % max(rules.batch_size, 1):
        raise NotImplementedError(
            f"a global batch of {x.shape[0]} over {rules.batch_size} ranks "
            "would be replicated, which the port does not execute")
    return local_slice(x, (rules.batch,), rules)


class NamedSharding:
    """A leaf's placement: ``spec`` over ``rules``' mesh, at this rank's
    coordinate."""

    def __init__(self, rules: ShardingRules, spec: Sequence):
        self.rules = rules
        self.spec = tuple(spec)

    def slice(self, x):
        return local_slice(x, self.spec, self.rules)


def named_shardings(tree, rules: ShardingRules) -> Any:
    """A tree mirroring the whole-shape ``tree`` with each leaf's
    :class:`NamedSharding` (specs by path, as ``param_pspecs``)."""
    from ..train.optimizer import tree_map

    specs = iter([spec for _, spec in leaf_pspecs(tree, rules)])
    return tree_map(lambda _: NamedSharding(rules, next(specs)), tree)
