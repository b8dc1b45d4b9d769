"""Training launcher CLI.

  python -m repro_torch.launch.train --arch qwen3-8b --smoke --steps 20 \\
      [--device cpu]

The reference's flags, plus ``--device`` (default ``cuda``: the kernels; ``cpu``:
their plain versions). Random float32 master weights from ``--seed``,
synthetic batches from ``data.SyntheticLMDataset``, AdamW with the cosine
schedule, the config's remat and compute dtype, checkpoint/restart
(auto-resume from ``--ckpt-dir``), straggler stats, optional int8 gradient
compression and gradient accumulation. Prints one JSON line per logged
step and, last, the kernel launches by route (zero on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from ..configs import get_config, list_archs, smoke_config
from ..core.device_common import resolve_device
from ..data import SyntheticLMDataset
from ..kernels.flash_attention import kernel as fa
from ..kernels.moe_gemm import kernel as mg
from ..models import init_params
from ..runtime import TrainLoopRunner
from ..train import AdamWConfig, init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"params={cfg.param_count()/1e6:.1f}M device={dev}")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev, dtype=torch.float32)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1))
    step_fn = make_train_step(cfg, opt_cfg,
                              compress_grads=args.compress_grads,
                              microbatches=args.microbatches)
    state = init_train_state(cfg, params, compress=args.compress_grads)

    ds = SyntheticLMDataset(cfg.vocab, args.seq, args.batch,
                            seed=args.seed, input_kind=cfg.input_kind,
                            d_model=cfg.d_model)

    def batches(step):
        out = {k: torch.from_numpy(v).to(dev)
               for k, v in ds.batch(step).items()}
        out["tokens"] = out["tokens"].long()
        return out

    def log(step, metrics):
        print(json.dumps({"step": step, **{k: round(v, 4)
                                           for k, v in metrics.items()}}))

    fa.reset_launches()
    mg.reset_launches()
    runner = TrainLoopRunner(step_fn, state, args.ckpt_dir,
                             ckpt_every=args.ckpt_every)
    runner.run(batches, args.steps, log_every=5, log_fn=log)
    print(json.dumps({"flash_attention": fa.flash_attention.route_launches,
                      "moe_gemm": mg.moe_gemm.route_launches}))
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
