"""The reference's parameter tree, as numpy arrays, in the port's layout.

``repro.models.init_params`` returns ``{"embed", "final_norm", "period":
{"pos{i}": block tree}}`` where every block leaf carries a leading
``n_periods`` axis. The port keeps a flat list of per-layer trees: layer
``p * len(pattern) + i`` is period ``p`` of pattern position ``i``. The
caller converts the reference's arrays to numpy (``np.asarray`` on each
leaf); the port never sees a JAX array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.device_common import resolve_device

__all__ = ["params_from_reference"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(np_params, cfg: ModelConfig, device="cuda",
                          dtype: Optional[torch.dtype] = None):
    """Numpy reference tree -> the port's ``{"embed", "final_norm",
    "layers"}`` on ``device``, in ``dtype`` (None keeps each array's own
    dtype)."""
    dev = resolve_device(device)

    def put(a):
        t = torch.from_numpy(np.array(a))   # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    layers = []
    for p in range(cfg.n_periods):
        for i in range(len(cfg.pattern)):
            layers.append(_tree_map(lambda a: put(np.asarray(a)[p]),
                                    np_params["period"][f"pos{i}"]))
    return {"embed": put(np_params["embed"]),
            "final_norm": _tree_map(put, np_params["final_norm"]),
            "layers": layers}
