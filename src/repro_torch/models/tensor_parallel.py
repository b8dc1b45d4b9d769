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

Two operators serve a layer whose parts are not a contiguous block of a
leaf (mamba2's mixer, ``models.mamba2``): :func:`regroup` moves the
columns of a column-split product from the contiguous block each rank
computed to the ranks that use them (a column may go to every rank), and
:func:`line_sum` sums a value every rank needs whole but computes only a
part of (the gated norm's sum of squares over its heads), whose consumers
each rank again runs only for its part: its backward is a sum too.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.collectives import MeshComm, mesh_comm, psum, tp_copy
from ..sharding.rules import current_rules

__all__ = ["TP", "tp_group", "row_parallel", "line_sum", "regroup"]


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


def line_sum(x, tp: TP):
    """The sum over the line of every rank's part ``x`` (the same bits on
    each rank), for consumers that each rank runs only for its own part:
    the backward sums the gradient's parts over the line too (``psum``,
    then ``tp_copy``; both counted as ``"tp"``)."""
    return tp_copy(psum(x, tp.comm, tp.dims, "tp"), tp.comm, tp.dims)


Ranges = Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=None)
def _routes(width: int, need: Tuple[Ranges, ...], device: torch.device):
    """For columns ``[0, width)`` cut into P contiguous blocks, one a
    member, and ``need[q]`` the ascending column ranges member q uses:
    ``cols[r][q]``, the columns of member r's block that member q uses, as
    indices into that block (ascending), on ``device``."""
    p = len(need)
    w = width // p
    cols: List[List[torch.Tensor]] = []
    for r in range(p):
        lo, hi = r * w, (r + 1) * w
        row = []
        for q in range(p):
            idx = [c - lo for a, b in need[q]
                   for c in range(max(a, lo), min(b, hi))]
            row.append(torch.tensor(idx, dtype=torch.long, device=device))
        cols.append(row)
    return cols


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blk, tp, need):
        cols = _routes(blk.shape[-1] * tp.size, need, blk.device)
        me, lead = tp.index, tuple(blk.shape[:-1])
        ctx.args = (tp, cols, blk.shape[-1], blk.dtype)
        got = tp.comm.exchange(
            [blk.index_select(-1, c) for c in cols[me]],
            tp.dims, "tp",
            shapes=[lead + (len(cols[r][me]),) for r in range(tp.size)])
        return torch.cat(got, dim=-1)

    @staticmethod
    def backward(ctx, g):
        tp, cols, width, dtype = ctx.args
        me, lead = tp.index, tuple(g.shape[:-1])
        got = tp.comm.exchange(
            list(g.split([len(cols[r][me]) for r in range(tp.size)], -1)),
            tp.dims, "tp",
            shapes=[lead + (len(cols[me][q]),) for q in range(tp.size)])
        out = torch.zeros(lead + (width,), dtype=torch.float32,
                          device=g.device)
        for q, piece in enumerate(got):          # in member order
            out.index_add_(-1, cols[me][q], piece.float())
        return out.to(dtype), None, None


def regroup(blk, tp: TP, need: Sequence[Sequence[Tuple[int, int]]]):
    """The columns this rank uses of a product whose ``P·w`` columns the
    line computes in contiguous blocks (``blk``: this rank's block, its
    columns last): ``need[q]`` are the ascending column ranges member q
    uses (several members may use a column), and this rank gets its own
    ranges' columns joined in ascending order, by one uneven all-to-all
    (``exchange(shapes=)``, counted as ``"tp"``). Backward: each column's
    gradient parts sent back to the rank that computed it and summed
    there in float32 in member order, in ``blk``'s dtype."""
    need = tuple(tuple((int(a), int(b)) for a, b in n) for n in need)
    return _Regroup.apply(blk, tp, need)
