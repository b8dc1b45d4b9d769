"""Batched betweenness centrality over distributed SpGEMM (paper §IV.C), on
the port.

    PYTHONPATH=src python examples/torch/betweenness_centrality.py \
        [--device cpu]

The torch twin of ``examples/betweenness_centrality.py``: the §V.A
decision procedure end to end — CV/memA on the native ordering; past the
threshold, graph-partition first; then batched multi-source Brandes with
the sparsity-aware 1D SpGEMM (``core.spgemm_1d``, the host path, as in the
reference), reporting per-phase communication. ``--device`` is taken for a
command line like the other twins' and nothing here runs on it. ``main``
returns the printed numbers.
"""

import argparse

import numpy as np

from repro_torch.apps import bc_batch
from repro_torch.core import (block_diagonal_noise, cv_over_mema,
                              multilevel_partition, partition_to_permutation,
                              permute_symmetric, spgemm_1d)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1536)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--nparts", type=int, default=16)
    ap.add_argument("--sources", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    nparts = args.nparts
    g = block_diagonal_noise(args.n, args.blocks, d_in=5.0, d_out=0.3,
                             seed=2)
    print(f"graph: {g.nrows} vertices, {g.nnz} edges")

    cv = cv_over_mema(g, g, nparts)
    print(f"CV/memA (native order) = {cv:.3f}")
    if cv > 0.3:
        print("  > 0.3 -> partitioning first (paper §V.A)")
        rep = multilevel_partition(g, nparts, seed=0)
        perm, splits = partition_to_permutation(rep.parts, nparts)
        g = permute_symmetric(g, perm)
        print(f"  edge cut {rep.cut}, imbalance {rep.weight_imbalance:.2f}")
    else:
        perm = np.arange(g.nrows)

    sources = perm[np.arange(args.sources)]

    def dist(x, y, semiring):
        r = spgemm_1d(x, y, nparts, semiring=semiring)
        return r.concat(), r.plan.total_fetched_bytes

    res = bc_batch(g, sources, spgemm_fn=dist)
    print(f"BFS levels: {res.depths}, forward SpGEMMs: "
          f"{res.fwd_spgemm_calls}, backward: {res.bwd_spgemm_calls}")
    print(f"total fetched: {res.comm_bytes / 2**20:.2f} MiB")
    top = np.argsort(-res.scores)[:5]
    print("top-5 central vertices:", top.tolist())
    return {"edges": g.nnz, "cv": cv, "depths": res.depths,
            "fwd": res.fwd_spgemm_calls, "bwd": res.bwd_spgemm_calls,
            "comm_bytes": res.comm_bytes, "top": top.tolist(),
            "scores": res.scores}


if __name__ == "__main__":
    main()
