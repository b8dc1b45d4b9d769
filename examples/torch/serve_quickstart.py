"""Multi-tenant SpGEMM serving quickstart (the port).

    PYTHONPATH=src python examples/torch/serve_quickstart.py [--device cpu]

The torch twin of ``examples/serve_quickstart.py``: two tenants share one
social-graph structure. Alice repeatedly squares the shared adjacency
(her concurrent requests coalesce into ONE cached multiply); Bob squares a
values-reweighted twin of the same structure, which rides the session's
values-only repack path on the plan Alice warmed. One plan, one trace
(an executable build), every caller answered, on ``--device`` (``cuda``:
the ``bsr_spgemm`` kernel at bs 32; ``cpu``: its plain version). Both tenants' last results
are held bitwise against the host oracle (an ``AssertionError``
otherwise). ``main`` returns the printed numbers.
"""

import argparse

import numpy as np

from repro_torch.core import banded_clustered, spgemm_1d
from repro_torch.serve import ServicePolicy, SpGEMMRequest, SpGEMMService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    g = banded_clustered(args.n, 16, 6.0, seed=0)
    g.data[:] = np.rint(2 * g.data)
    g.data[g.data == 0] = 1.0
    g = g.astype(np.float32)

    # bob's edge weights differ; the sparsity structure is identical
    g_bob = g.astype(np.float32)
    g_bob.data[:] = g.data * 3.0

    svc = SpGEMMService(policy=ServicePolicy(tenant_quota=8),
                        device=args.device)
    print(f"shared graph {g.shape}, nnz={g.nnz}")

    # warm the shared plan before traffic arrives
    svc.prefetch("alice", g, g, bs=32)

    waves = []
    for wave in range(3):
        reqs = [SpGEMMRequest(tenant="alice", a=g, b=g, bs=32)
                for _ in range(4)]
        reqs += [SpGEMMRequest(tenant="bob", a=g_bob, b=g_bob, bs=32)
                 for _ in range(4)]
        results = svc.serve(reqs)
        served = sum(r.ok for r in results)
        hits = sum(r.cache_hit for r in results)
        waves.append((served, hits))
        print(f"wave {wave}: {served}/{len(results)} served, "
              f"{hits} from the warm plan")

    st = svc.stats()
    sess = svc.session.stats
    print(f"\ncoalesce rate {st['coalesce_rate']:.0%}, "
          f"cache hit rate {st['cache_hit_rate']:.0%}, "
          f"p50 {st['latency_p50_s'] * 1e3:.2f} ms")
    print(f"session: {sess['traces']} trace serves both tenants "
          f"({sess['payload_repacks']} values-only repacks, "
          f"{sess['bytes_cached'] / 2**20:.2f} MiB cached)")

    # both tenants got *their* answer: spot-check against the host oracle
    alice = next(r for r in results if r.tenant == "alice")
    bob = next(r for r in results if r.tenant == "bob")
    ref_a = spgemm_1d(g, g, 1).concat().prune(0.0).astype(np.float32)
    ref_b = spgemm_1d(g_bob, g_bob, 1).concat().prune(0.0).astype(np.float32)
    assert np.array_equal(alice.value.data, ref_a.data)
    assert np.array_equal(bob.value.data, ref_b.data)
    print("oracle check: both tenants bitwise-correct")
    return {"waves": waves, "coalesce_rate": st["coalesce_rate"],
            "cache_hit_rate": st["cache_hit_rate"],
            "traces": sess["traces"], "repacks": sess["payload_repacks"],
            "oracle": True}


if __name__ == "__main__":
    main()
