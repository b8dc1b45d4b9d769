"""Carry host state across from the reference package as plain arrays.

The port never imports ``repro``; these functions build its objects from
the plain fields of the reference's (numpy arrays, ints, tuples, names), so
a test can run the port's ring or SUMMA on the reference planner's own
plan.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .blocksparse import BlockSparse
from .plan import Partition1D
from .semiring import by_name
from .sparse import CSC
from .spgemm_1d_device import DeviceSpGEMMPlan
from .spgemm_2d_device import SummaDevicePlan

__all__ = ["csc_from_arrays", "blocksparse_from_arrays",
           "plan_from_reference", "summa_plan_from_reference"]


def csc_from_arrays(shape: Tuple[int, int], indptr, indices, data) -> CSC:
    """A CSC from its arrays (copied; index arrays as int64)."""
    return CSC(np.array(indptr, dtype=np.int64),
               np.array(indices, dtype=np.int64), np.array(data),
               (int(shape[0]), int(shape[1])))


def blocksparse_from_arrays(tiles, tile_rows, tile_cols,
                            shape: Tuple[int, int],
                            orig_shape: Tuple[int, int], bs: int,
                            fill: float = 0.0) -> BlockSparse:
    """A BlockSparse from its payloads and tile coordinates (copied)."""
    return BlockSparse(tiles=np.array(tiles),
                       tile_rows=np.array(tile_rows, dtype=np.int32),
                       tile_cols=np.array(tile_cols, dtype=np.int32),
                       shape=(int(shape[0]), int(shape[1])),
                       orig_shape=(int(orig_shape[0]), int(orig_shape[1])),
                       bs=int(bs), fill=float(fill))


def _carry(cls, fields: dict):
    """An instance of the plan dataclass ``cls`` from a reference plan's
    fields: arrays copied, the semiring by name, partitions by splits."""
    names = {f.name for f in dataclasses.fields(cls)}
    missing = names - set(fields)
    if missing:
        raise ValueError(f"plan fields missing: {sorted(missing)}")
    kw = {}
    for name in names:
        v = fields[name]
        if name == "semiring":
            v = by_name(getattr(v, "name", v))
        elif name.startswith("part_"):
            v = Partition1D(np.array(getattr(v, "splits", v),
                                     dtype=np.int64))
        elif isinstance(v, np.ndarray):
            v = v.copy()
        elif name == "stats":
            v = dict(v)
        kw[name] = v
    return cls(**kw)


def plan_from_reference(fields: dict) -> DeviceSpGEMMPlan:
    """The port's :class:`DeviceSpGEMMPlan` from a reference plan's fields.

    ``fields`` maps every field name of the reference
    ``DeviceSpGEMMPlan`` to its value (``vars(plan)`` will do). Arrays are
    copied; ``semiring`` may be the semiring's name or any object with a
    ``name``; ``part_k`` / ``part_n`` may be split arrays or any object with
    ``splits``. The port's registered semiring of that name is used.
    """
    return _carry(DeviceSpGEMMPlan, fields)


def summa_plan_from_reference(fields: dict) -> SummaDevicePlan:
    """The port's :class:`SummaDevicePlan` from a reference SUMMA plan's
    fields (``vars(plan)`` of ``repro.core.spgemm_2d_device``'s), carried
    as :func:`plan_from_reference` carries a ring plan's."""
    return _carry(SummaDevicePlan, fields)
