"""Serving launcher CLI — batched generation through the ServeEngine.

  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b [--smoke] \\
      [--device cpu]

Random weights from ``--seed`` in the config's compute dtype on either
device (bfloat16 for the published configs, float32 for the ``--smoke``
ones); random prompts of 2 to ``--prompt-len`` tokens.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import get_config, list_archs, smoke_config
from ..core.device_common import resolve_device
from ..models import init_params
from ..models.layers import compute_dtype
from ..serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode steps between early-exit host syncs "
                         "(0 = never probe, run all --max-new steps)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev,
                         dtype=compute_dtype(cfg.dtype))
    engine = ServeEngine(cfg, params, max_len=args.max_len,
                         batch_slots=args.requests, device=dev)

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab,
                            size=rng.integers(2, args.prompt_len + 1))
               .astype(np.int32) for _ in range(args.requests)]
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new_tokens=args.max_new,
                          sync_every=args.sync_every)
    dt = time.perf_counter() - t0
    total_new = int(res.lengths.sum())
    print(f"generated {total_new} tokens for {len(prompts)} requests "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s) on {dev}")
    for i, row in enumerate(res.tokens):
        print(f"req{i}: prompt_len={len(prompts[i])} -> {row.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
