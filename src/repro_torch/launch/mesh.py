"""Meshes over the ranks of the default process group.

The port of ``repro.launch.mesh``: the reference's production shapes and
axis names, and a small mesh for tests and examples. Building a mesh is
collective (every rank of the group calls it).
"""

from __future__ import annotations

from ..core.device_common import device_grid_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod. Raises
    (``ValidationError``) unless the world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_grid_mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1):
    """A ``(data, model)`` mesh of the world's first ``data * model``
    ranks."""
    return device_grid_mesh((data, model), ("data", "model"))
