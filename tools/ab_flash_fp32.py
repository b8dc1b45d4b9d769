#!/usr/bin/env python3
"""Time the float32 attention kernel (the port's ``fp32`` route) of two or
more source trees on one CUDA card, in the order A, B, ..., ..., B, A.

    python3 tools/ab_flash_fp32.py TREE_A TREE_B [...] [--rounds 5]
        [--reps 10]

A tree is a checkout of this repo, or its ``src`` alone (for example a
``git archive`` of another commit unpacked under ``build/``). Each run is a
process of its own with that tree's ``src`` first on ``sys.path``, so each builds and
launches its own kernel. The inputs are the shape of the float32 check's
prefill attention in ``chip_smoke.py``: q, k and v (4, 2048, 16, 128),
causal, scale 128^-0.5, seeded normals made on the card. Each run checks
the kernel against the tree's plain version (atol 2e-5, rtol 1e-4), then
takes ``--rounds`` readings of CUDA events around ``--reps`` back-to-back
wrapper calls after one warm-up, as ``chip_smoke.py`` times a kernel.
Prints one JSON line per run (with ptxas's line for the kernel the run
built), the card's name and power limit, and a summary line with each
tree's median and its ratio to the first tree's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPE = (4, 2048, 16, 128)


def child(tree: str, rounds: int, reps: int) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention.kernel import (TF32_SOURCE,
                                                            flash_attention)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SHAPE, device="cuda", generator=g)
               for _ in range(3))
    kw = dict(scale=SHAPE[3] ** -0.5, causal=True)
    got, want = flash_attention(q, k, v, **kw), mha_ref(q, k, v, **kw)
    diff = (got - want).abs()
    ok = bool((diff <= 2e-5 + 1e-4 * want.abs()).all())
    del got, want
    fn = lambda: flash_attention(q, k, v, **kw)
    ms = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1) / reps)
    log = cuda_lib.library_path(TF32_SOURCE).with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    print(json.dumps({"tree": tree, "ok": ok,
                      "max_abs_err": float(diff.max()), "ms": ms,
                      "ptxas": ptxas}))
    if not ok:
        sys.exit(1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.rounds, args.reps)
        return 0
    trees = args.trees
    if len(trees) < 2:
        ap.error("give two trees or more")
    runs = []
    for tree in trees + trees[::-1]:
        out = subprocess.run(
            [sys.executable, __file__, "--child", tree, "--rounds",
             str(args.rounds), "--reps", str(args.reps)],
            capture_output=True, text=True, check=False)
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            print(out.stdout, end="")
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line)
        runs.append(json.loads(line))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    median = {t: statistics.median(
        m for r in runs if r["tree"] == t for m in r["ms"]) for t in trees}
    print(json.dumps({"median_ms": median,
                      "over_first": {t: median[t] / median[trees[0]]
                                     for t in trees}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
