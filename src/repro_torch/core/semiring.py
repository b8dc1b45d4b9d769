"""Semirings for SpGEMM — the host *and* device contract (torch side).

Each semiring supplies two layers of the same algebra:

  * **host (numpy)**: the scalar multiply, a segment-reduce for the additive
    monoid, and the additive identity used to prune explicit zeros — the
    same functions as ``repro.core.semiring``;
  * **device (torch)**: the dense-tile contract the block-sparse engines
    consume — a batched tile product (``matmul``), the additive combine
    (``add``), the fused step on one ``(bs, bs)`` accumulator
    (``tile_combine``), a segment-reduce over the additive monoid
    (``segment_reduce``: ``scatter_reduce`` with ``sum``/``amax``/``amin``
    into an output filled with the identity), and a reduce of the additive
    monoid over one tensor dim (``axis_reduce``: ``sum``/``amax``/``amin``;
    the reference's ``jnp_axis_reduce`` reduces over a named mesh axis with
    ``psum``/``pmax``/``pmin``, and the Split-3D merge over logical layers
    on one device reduces over a tensor dim instead).

Device code never spells a literal ``0.0``: every payload pad, accumulator
reset, empty-schedule output and decode prune goes through ``Semiring.zero``
/ ``prune_mask``. In all registered semirings the additive identity is also
the multiplicative annihilator (0 for +·, 0 for ∨∧, +inf for min-plus), so
identity-padded dense tiles multiply to identity contributions at absent
positions.

plus-times and bool products run in full float32: a caller that runs them
on a CUDA device keeps ``torch.backends.cuda.matmul.allow_tf32`` False
(PyTorch's default), or the plain version stops being exact on integer
inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["Semiring", "PLUS_TIMES", "BOOL_OR_AND", "MIN_PLUS", "by_name"]


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    # scalar/vector multiply on numpy arrays
    mul: Callable[[np.ndarray, np.ndarray], np.ndarray]
    # segment-reduce of the additive monoid: (vals, segment_starts) -> reduced
    add_reduceat: Callable[[np.ndarray, np.ndarray], np.ndarray]
    # additive identity (entries equal to this are pruned from results);
    # doubles as the multiplicative annihilator in all registered semirings,
    # so it is the correct fill for absent positions of dense tiles
    zero: float
    # torch-side ops for dense-tile execution (a/b: [..., bs, bs] stacks)
    matmul: Callable       # (a_tiles, b_tiles) -> c_tiles contribution
    add: Callable          # (acc, contribution) -> acc
    # fused step on one accumulator: acc <- acc (+) a ⊗ b
    tile_combine: Callable
    # (vals [nprod, ...], segment_ids, num_segments) -> [num_segments, ...];
    # segments no product targets come back as ``zero``
    segment_reduce: Callable
    # (vals, dim, out=None) -> vals reduced over ``dim`` under the additive
    # monoid — the Split-3D cross-layer merge
    axis_reduce: Callable

    def prune_mask(self, vals, tol: float = 0.0):
        """Entries considered nonzero by this semiring: |v - 0̄| > tol for
        a finite identity; exactly the finite entries for an infinite one.
        Takes a numpy array or a torch tensor and answers in kind."""
        lib = torch if isinstance(vals, torch.Tensor) else np
        if np.isinf(self.zero):
            return lib.isfinite(vals)
        return lib.abs(vals - self.zero) > tol

    def fill(self, shape, dtype=np.float32) -> np.ndarray:
        """Host-side array of additive identities (payload-pad fill)."""
        return np.full(shape, self.zero, dtype=dtype)


def _segment_reduce(reduce: str, zero: float) -> Callable:
    def segment_reduce(vals, seg, n):
        out = torch.full((n,) + tuple(vals.shape[1:]), zero,
                         dtype=vals.dtype, device=vals.device)
        idx = seg.to(torch.int64).view((-1,) + (1,) * (vals.dim() - 1))
        return out.scatter_reduce_(0, idx.expand_as(vals), vals,
                                   reduce=reduce, include_self=True)
    return segment_reduce


def _make_plus_times() -> Semiring:
    return Semiring(
        name="plus_times",
        mul=np.multiply,
        add_reduceat=lambda v, s: np.add.reduceat(v, s),
        zero=0.0,
        matmul=lambda a, b: torch.matmul(a.float(), b.float()),
        add=torch.add,
        tile_combine=lambda acc, a, b: acc + torch.matmul(a, b),
        segment_reduce=_segment_reduce("sum", 0.0),
        axis_reduce=lambda v, dim, out=None: torch.sum(v, dim, out=out),
    )


def _make_bool_or_and() -> Semiring:
    # booleans are {0.0, 1.0}; or == max, and == min(prod on 0/1)
    def _bool_matmul(a, b):
        return torch.clamp(torch.matmul((a != 0).float(), (b != 0).float()),
                           0.0, 1.0)

    return Semiring(
        name="bool_or_and",
        mul=lambda a, b: (a != 0).astype(np.float64) * (b != 0),
        add_reduceat=lambda v, s: np.maximum.reduceat(v, s),
        zero=0.0,
        matmul=_bool_matmul,
        add=torch.maximum,
        tile_combine=lambda acc, a, b: torch.maximum(acc, _bool_matmul(a, b)),
        segment_reduce=_segment_reduce("amax", 0.0),
        axis_reduce=lambda v, dim, out=None: torch.amax(v, dim, out=out),
    )


def _make_min_plus() -> Semiring:
    inf = float("inf")

    def _mp_stream(acc, a, b):
        # stream rank-1 (column + row) updates over k into ``acc`` in
        # place, keeping every intermediate at the accumulator's size —
        # never the O(bs³) cube
        for k in range(a.shape[-1]):
            torch.minimum(acc, a[..., :, k, None] + b[..., None, k, :],
                          out=acc)
        return acc

    def _mp_matmul(a, b):
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        start = torch.full(batch + (a.shape[-2], b.shape[-1]), inf,
                           dtype=torch.float32, device=a.device)
        return _mp_stream(start, a.float(), b.float())

    return Semiring(
        name="min_plus",
        mul=np.add,
        add_reduceat=lambda v, s: np.minimum.reduceat(v, s),
        zero=inf,
        matmul=_mp_matmul,
        add=torch.minimum,
        tile_combine=lambda acc, a, b: _mp_stream(acc.clone(), a, b),
        segment_reduce=_segment_reduce("amin", inf),
        axis_reduce=lambda v, dim, out=None: torch.amin(v, dim, out=out),
    )


PLUS_TIMES = _make_plus_times()
BOOL_OR_AND = _make_bool_or_and()
MIN_PLUS = _make_min_plus()

_REGISTRY = {s.name: s for s in (PLUS_TIMES, BOOL_OR_AND, MIN_PLUS)}


def by_name(name: str) -> Semiring:
    return _REGISTRY[name]
