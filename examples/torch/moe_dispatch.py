"""The paper's technique inside an LM: SpGEMM-framed MoE dispatch (the
port).

    PYTHONPATH=src python examples/torch/moe_dispatch.py [--device cpu]

The torch twin of ``examples/moe_dispatch.py``: the token->expert routing
matrix as the sparse A of Algorithm 1, capacity buckets as the
block-fetch unit, and the required-vs-fetched accounting that the paper
reports for RDMA traffic (DESIGN.md §3), from ``moe_apply``'s
``moe/routed_tokens``, ``moe/capacity_slots`` and ``moe/dropped``. The
smoke config's float32 weights from a seeded ``torch.Generator`` (seed 0;
the tokens seed 1): on ``cuda`` the expert FFNs run the ``moe_gemm``
kernel's float32 route, on ``cpu`` its plain version. ``setup`` makes
the config, the weights and the tokens; ``report`` prints and returns the
numbers for given weights and tokens.
"""

import argparse

import torch

from repro_torch.configs import smoke_config
from repro_torch.core.device_common import resolve_device
from repro_torch.models.moe import moe_apply, moe_init


def report(cfg, params, x):
    y, aux, m = moe_apply(params, cfg, x)
    routed = int(m["moe/routed_tokens"])
    slots = int(m["moe/capacity_slots"])
    dropped = int(m["moe/dropped"])
    print(f"tokens routed (paper: required bytes) : {routed}")
    print(f"capacity slots (paper: fetched bytes) : {slots}")
    print(f"over-fetch ratio (block-fetch padding): {slots / routed:.2f}x")
    print(f"dropped at capacity                   : {dropped}")
    print(f"router aux loss                       : {float(aux):.5f}")
    finite = bool(torch.isfinite(y).all())
    print(f"output: {tuple(y.shape)}, finite={finite}")
    return {"routed": routed, "slots": slots, "dropped": dropped,
            "aux": float(aux), "y": y, "finite": finite}


def setup(argv=None):
    """(config, weights, tokens) on ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config("qwen2-moe-a2.7b")
    dtype = getattr(torch, cfg.dtype)
    params = moe_init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev, dtype=dtype)
    x = torch.randn((8, 64, cfg.d_model), dtype=dtype, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    return cfg, params, x


def main(argv=None):
    cfg, params, x = setup(argv)
    moe = cfg.moe
    print(f"{cfg.name}: {moe.n_experts} routed experts (top-{moe.top_k}) "
          f"+ {moe.n_shared} shared, padded to {moe.n_experts_padded} "
          f"for EP sharding")
    return report(cfg, params, x)


if __name__ == "__main__":
    main()
