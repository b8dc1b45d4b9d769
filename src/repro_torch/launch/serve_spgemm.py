"""SpGEMM serving CLI — multi-tenant coalescing service over sessions.

  python -m repro_torch.launch.serve_spgemm \\
      --tenants 3 --requests 8 --n 512 [--quota 4] [--algorithm 1d] \\
      [--device cpu]

Simulates a mixed multi-tenant workload against one shared graph
structure: every tenant repeatedly multiplies the same adjacency (their
requests coalesce into one cached plan/executable), plus a per-tenant
values-jittered variant that rides the session's repack path. Prints each
drain's outcomes, the final SERVICE_STATS telemetry surface, the
``bsr_spgemm`` kernel's launches by route and, on a CUDA device, the peak
device memory. Exits 1 if any request failed. ``--device`` is ``cuda`` by
default (the kernels; it raises without a CUDA device); ``cpu`` runs the
plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core.semiring import by_name
from ..core.sparse import banded_clustered
from ..kernels.bsr_spgemm import bsr_spgemm
from ..serve import ServicePolicy, SpGEMMRequest, SpGEMMService


def main(argv=None):
    """Run the CLI on ``argv``; returns the exit code."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512, help="graph dimension")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per tenant per wave")
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--algorithm", choices=("1d", "2d", "3d"), default="1d")
    ap.add_argument("--semiring",
                    choices=("plus_times", "bool_or_and", "min_plus"),
                    default="plus_times")
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--quota", type=int, default=None,
                    help="max cached entries per tenant (None = unbounded)")
    ap.add_argument("--max-mb", type=float, default=None,
                    help="global device byte budget in MiB")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    g = banded_clustered(args.n, max(args.n // 40, 8), 6.0, seed=args.seed)
    g.data[:] = np.rint(2 * g.data)
    g.data[g.data == 0] = 1.0
    g = g.astype(np.float32)

    policy = ServicePolicy(
        tenant_quota=args.quota,
        max_bytes=int(args.max_mb * 2**20) if args.max_mb else None)
    svc = SpGEMMService(policy=policy, device=args.device)
    on_card = svc.session.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(svc.session.device)
    launches = dict(bsr_spgemm.route_launches)
    sr = by_name(args.semiring)
    tenants = [f"tenant{i}" for i in range(args.tenants)]

    # warm the shared structure once; every tenant's first wave then hits
    print(f"prefetch shared {g.shape} graph (nnz={g.nnz}) ...")
    svc.prefetch(tenants[0], g, g, algorithm=args.algorithm,
                 semiring=sr, bs=args.bs)

    for wave in range(args.waves):
        for i, tenant in enumerate(tenants):
            jit = g.astype(np.float32)
            jit.data[:] = g.data + float(i + 1)     # same structure, values
            for k in range(args.requests):
                op = g if k % 2 == 0 else jit
                svc.submit(SpGEMMRequest(tenant=tenant, a=op, b=op,
                                         algorithm=args.algorithm,
                                         semiring=sr, bs=args.bs))
        results = svc.run_pending()
        ok = sum(r.ok for r in results.values())
        co = sum(r.coalesced for r in results.values())
        print(f"wave {wave}: {ok}/{len(results)} served, "
              f"{co} rode a coalesced group")

    stats = svc.stats()
    print("--- SERVICE_STATS ---")
    for k, v in stats.items():
        print(f"  {k:22s} {v}")
    sess = svc.session.stats
    print(f"session: {sess['plan_cache_hits']} hits / "
          f"{sess['plan_cache_misses']} misses, "
          f"{sess['payload_repacks']} repacks, {sess['traces']} builds, "
          f"{sess['bytes_cached'] / 2**20:.2f} MiB cached")
    print("bsr_spgemm launches by route: "
          + ", ".join(f"{r} {bsr_spgemm.route_launches[r] - n}"
                      for r, n in launches.items()))
    if on_card:
        peak = torch.cuda.max_memory_allocated(svc.session.device)
        print(f"peak device memory: {peak / 1e9:.3f} GB")
    return 0 if stats["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
