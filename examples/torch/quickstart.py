"""Quickstart: sparsity-aware 1D SpGEMM in five minutes (the port).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The torch twin of ``examples/quickstart.py``, on ``repro_torch``: builds a
structured sparse matrix, squares it with the paper's Algorithm 1 across
8 logical processes, shows the communication plan (hit vectors + block
fetches), compares against 2D sparse SUMMA, and verifies the result
against the dense oracle. Every step is a host path, as in the
reference; ``--device`` is taken for a command line like the other
twins' and nothing here runs on it. ``main`` returns the printed numbers.
"""

import argparse

import numpy as np

from repro_torch.core import (Partition1D, banded_clustered, build_fetch_plan,
                              cv_over_mema, permute_symmetric,
                              random_permutation, spgemm_1d,
                              summa2d_comm_volume)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--nparts", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, nparts = args.n, args.nparts
    a = banded_clustered(n, band=16, d=8.0, seed=0)
    print(f"A: {a.shape}, nnz={a.nnz}, nzc={a.nzc}")

    # --- the symbolic phase: what would move? -------------------------------
    part = Partition1D.balanced(n, nparts)
    plan = build_fetch_plan(a, a, part, part, nblocks=64)
    print(f"planned fetch: {plan.total_fetched_bytes / 2**20:.3f} MiB "
          f"(exact need {plan.total_required_bytes / 2**20:.3f} MiB) "
          f"in {plan.total_messages} messages")
    print(f"CV/memA = {plan.cv_over_mema:.3f} "
          f"({'partition first!' if plan.cv_over_mema > 0.3 else 'good as-is'})")

    # --- run it --------------------------------------------------------------
    res = spgemm_1d(a, a, nparts)
    c = res.concat()
    dense = a.to_dense()
    ok = np.allclose(c.to_dense(), dense @ dense, atol=1e-8)
    print(f"C = A @ A: nnz={c.nnz}, correct={ok}")

    # --- why sparsity-awareness matters --------------------------------------
    v2d = summa2d_comm_volume(a, a, int(np.sqrt(nparts)))
    print(f"2D SUMMA would move {v2d['total_bytes'] / 2**20:.3f} MiB "
          f"({v2d['total_bytes'] / max(plan.total_fetched_bytes, 1):.1f}x more)")

    # --- and why random permutation hurts the 1D algorithm ------------------
    ar = permute_symmetric(a, random_permutation(n, seed=1))
    cv_r = cv_over_mema(ar, ar, nparts)
    print(f"after random permutation CV/memA = {cv_r:.3f} "
          f"(vs {plan.cv_over_mema:.3f} native) — clustering is the asset")
    return {"nnz": a.nnz, "nzc": a.nzc,
            "fetched": plan.total_fetched_bytes,
            "required": plan.total_required_bytes,
            "messages": plan.total_messages, "cv": plan.cv_over_mema,
            "c_nnz": c.nnz, "correct": ok,
            "summa_bytes": v2d["total_bytes"], "cv_random": cv_r}


if __name__ == "__main__":
    main()
