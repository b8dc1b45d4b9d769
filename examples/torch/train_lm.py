"""End-to-end LM training driver (~100M params by default), on the port.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 300
    PYTHONPATH=src python examples/torch/train_lm.py --tiny --steps 30

The torch twin of ``examples/train_lm.py``: synthetic sharded data
pipeline -> mixed-precision train step (chunked CE, remat) -> AdamW+cosine
-> checkpoint every ``--ckpt-every`` (50) steps with auto-resume from
``--ckpt-dir`` -> straggler stats, on ``--device`` (``cuda``: the
attention kernel's float32 route; ``cpu``: its plain version). The model
is a qwen3-family decoder scaled to ~100M params (float32 weights from a
seeded ``torch.Generator``); cross-entropy drops visibly within a few
hundred steps on the structured synthetic stream. ``setup`` parses the
flags and makes the weights; ``train`` runs the loop from given weights
and returns the logged cross entropies.
"""

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device_common import resolve_device
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import init_params
from repro_torch.runtime import TrainLoopRunner
from repro_torch.train import AdamWConfig, init_train_state, make_train_step


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="repro-100m", family="dense", n_layers=10, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=3072, vocab=32768, head_dim=64,
        pattern=("a",), mlp="swiglu", qk_norm=True, dtype="float32",
        remat="none")


def model_tiny() -> ModelConfig:
    return dataclasses.replace(model_100m(), name="repro-tiny",
                               n_layers=2, d_model=128, d_ff=512,
                               vocab=2048)


def train(cfg, params, args, dev, log_every=10):
    """The loop from ``params`` (resuming from ``args.ckpt_dir``'s latest
    checkpoint, if any): ``[(step, cross entropy)]`` of the logged
    steps."""
    opt = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(cfg, opt)
    state = init_train_state(cfg, params)
    ds = SyntheticLMDataset(cfg.vocab, args.seq, args.batch, seed=0)

    runner = TrainLoopRunner(step, state, args.ckpt_dir,
                             ckpt_every=args.ckpt_every)
    losses = []

    def log(s, m):
        losses.append((s, m["loss/ce"]))
        print(json.dumps({"step": s, "ce": round(m["loss/ce"], 4),
                          "lr": round(m["opt/lr"], 6),
                          "sec/step": round(m["step_time_mean"], 3)}))

    def batches(s):
        return {k: torch.from_numpy(v).to(dev).long()
                for k, v in ds.batch(s).items()}

    runner.run(batches, num_steps=args.steps, log_every=log_every,
               log_fn=log)
    if len(losses) >= 2:
        first, last = losses[0][1], losses[-1][1]
        print(f"CE {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'check setup'})")
    return losses


def setup(argv=None):
    """(config, weights, flags, device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_tiny() if args.tiny else model_100m()
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.float32)
    return cfg, params, args, dev


def main(argv=None):
    return train(*setup(argv))


if __name__ == "__main__":
    main()
