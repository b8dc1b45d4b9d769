"""The reference's parameter tree and train state, as numpy arrays, in the
port's layout.

``repro.models.init_params`` returns ``{"embed", "final_norm", "period":
{"pos{i}": block tree}}`` where every block leaf carries a leading
``n_periods`` axis. The port keeps a flat list of per-layer trees: layer
``p * len(pattern) + i`` is period ``p`` of pattern position ``i``. The
caller converts the reference's arrays to numpy (``np.asarray`` on each
leaf); the port never sees a JAX array. :func:`train_state_from_reference`
does the same for a whole ``repro.train.TrainState`` (params, both AdamW
moments, step, error-feedback residual): how a JAX train checkpoint's
arrays come into the port, whose own checkpoints keep its own layout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.device_common import resolve_device

__all__ = ["params_from_reference", "train_state_from_reference"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_reference(np_params, cfg: ModelConfig, device="cuda",
                          dtype: Optional[torch.dtype] = None, rules=None):
    """Numpy reference tree -> the port's ``{"embed", "final_norm",
    "layers"}`` on ``device``, in ``dtype`` (None keeps each array's own
    dtype). ``rules`` (``sharding.ShardingRules``): only this rank's slice
    of each leaf (``sharding.placement.place``) goes to the device."""
    dev = resolve_device(device)
    if rules is not None:
        from ..sharding.placement import place

        host = params_from_reference(np_params, cfg, "cpu")
        return _tree_map(lambda t: t.to(device=dev, dtype=dtype or t.dtype),
                         place(host, rules))

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


def train_state_from_reference(np_state, cfg: ModelConfig, device="cuda",
                               dtype: Optional[torch.dtype] = None):
    """A reference ``TrainState`` with numpy leaves (``params``, ``opt.mu``,
    ``opt.nu``, ``opt.step``, ``residual`` or None) -> the port's
    ``train.TrainState`` on ``device``: the params in ``dtype`` (None keeps
    each array's dtype), the moments and the residual in float32, the step
    an int32 0-d tensor, each tree in :func:`params_from_reference`'s
    layout."""
    from ..train.optimizer import OptState
    from ..train.step import TrainState

    dev = resolve_device(device)
    f32 = lambda tree: params_from_reference(tree, cfg, dev, torch.float32)
    opt = np_state.opt
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=dev)
    residual = None if np_state.residual is None else f32(np_state.residual)
    return TrainState(params=params_from_reference(np_state.params, cfg, dev,
                                                   dtype),
                      opt=OptState(mu=f32(opt.mu), nu=f32(opt.nu),
                                   step=step),
                      residual=residual)
