"""Quickstart: Markov clustering on the persistent SpGEMM session (the
port).

    PYTHONPATH=src python examples/torch/mcl_quickstart.py [--device cpu]

The torch twin of ``examples/mcl_quickstart.py``: builds a
community-structured graph, clusters it with MCL — every expansion (M·M)
runs on the device SpGEMM path through a persistent ``SpGEMMSession`` on
``--device`` (``cuda``: the ``bsr_spgemm`` kernel at bs 32; ``cpu``: its
plain version) — and shows what the session amortized: once the
iteration's sparsity pattern settles, expansions stop paying for host
planning and retracing (executable builds). ``main`` returns the printed
numbers.
"""

import argparse

import numpy as np

from repro_torch.apps import mcl
from repro_torch.core import SpGEMMSession, block_diagonal_noise


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=240)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, nblocks = args.n, args.blocks
    g = block_diagonal_noise(n, nblocks, d_in=8.0, d_out=0.05, seed=7)
    g.data[:] = np.abs(g.data) + 0.5
    print(f"graph: {g.shape}, nnz={g.nnz}, {nblocks} planted communities")

    session = SpGEMMSession(device=args.device)
    res = mcl(g, inflation=1.5, prune_threshold=1e-3, session=session,
              bs=32)

    sizes = np.bincount(np.unique(res.clusters, return_inverse=True)[1])
    print(f"MCL: {res.iterations} expansions, converged={res.converged}, "
          f"{len(sizes)} clusters (sizes "
          f"{sorted(sizes.tolist(), reverse=True)})")

    s = session.stats
    first = {"misses": s["plan_cache_misses"], "hits": s["plan_cache_hits"],
             "calls": s["calls"], "traces": s["traces"]}
    print(f"session: {s['plan_cache_misses']} plans built, "
          f"{s['plan_cache_hits']} reused while the pattern settled, "
          f"{s['plan_seconds_saved'] * 1e3:.1f} ms of planning skipped")

    # re-cluster a later snapshot of the same graph: identical sparsity
    # structure, so every expansion replays a cached plan + executable
    hits_before = s["plan_cache_hits"]
    again = mcl(g, inflation=1.5, prune_threshold=1e-3, session=session,
                bs=32)
    print(f"re-clustering the same structure: "
          f"{s['plan_cache_hits'] - hits_before} of "
          f"{s['calls'] - res.iterations} expansions were cache hits — "
          f"zero new plans, zero retraces ({s['traces']} traces total)")
    return {"iterations": res.iterations, "converged": res.converged,
            "clusters": res.clusters, "sizes": sorted(sizes.tolist()),
            **first, "again_hits": s["plan_cache_hits"] - hits_before,
            "again_equal": bool(np.array_equal(again.clusters,
                                               res.clusters))}


if __name__ == "__main__":
    main()
