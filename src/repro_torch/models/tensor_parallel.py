"""Tensor parallelism over the rules' ``tp`` axis: the group a layer splits
its work over.

Under a profile with a ``tp`` axis of more than one rank (``default``,
``serve_tp``, ``ep_sharded``) every rank of a ``model`` line holds the same
slab of the batch and its slices of the leaves the rules split over
``model``; the layers move data between them explicitly
(``core.collectives``). The Megatron pair: the input operator
(``tp_copy``: the identity, backward a sum over the line) where a
replicated activation enters a region in which each rank computes only its
part (its columns, heads or vocab rows), the output operator (``psum``:
the sum, backward the identity) where the parts join. A replicated weight
used inside such a region goes through ``tp_copy`` too, so that its
gradient, a part on each rank, is summed over the line. Every rank of a
line then holds the whole loss and the same gradient of every leaf the
rules do not split over ``model``.

A row-split product's parts are computed and summed in float32 and
rounded once to the activation's dtype (:func:`row_parallel`), as the
one-process product accumulates in float32 and rounds once; the input
operator's backward sums the gradient's parts in float32 too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from ..core.collectives import MeshComm, mesh_comm, psum
from ..sharding.rules import current_rules

__all__ = ["TP", "tp_group", "row_parallel"]


class TP(NamedTuple):
    comm: MeshComm
    dims: Tuple[str, ...]     # the tp axis, as a MeshComm dims tuple
    size: int                 # ranks on the line
    index: int                # this rank's place on it

    def splits(self, n: int) -> bool:
        """Does the rules' table split a dim of ``n`` over the line
        (``rules._spec_for`` keeps a dim the axis does not divide
        whole)?"""
        return n % self.size == 0


def tp_group() -> Optional[TP]:
    """The rules' tensor-parallel line of this rank, or None: no rules, no
    ``tp`` axis, or an axis of one rank."""
    rules = current_rules()
    if rules is None or rules.tp is None or rules.axis_size(rules.tp) <= 1:
        return None
    comm = mesh_comm(rules.mesh)
    dims = (rules.tp,)
    return TP(comm, dims, comm.size(dims), comm.index(dims))


def row_parallel(x, w, tp: TP):
    """``x @ w`` for ``w`` this rank's rows and ``x`` its columns: the
    parts in float32, summed over the line (``psum``, counted as
    ``"tp"``), rounded once to ``x``'s dtype."""
    return psum(x.float() @ w.float(), tp.comm, tp.dims, "tp").to(x.dtype)
