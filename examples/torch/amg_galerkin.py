"""AMG Galerkin product RᵀAR with distributed SpGEMM (paper §IV.B), on the
port.

    PYTHONPATH=src python examples/torch/amg_galerkin.py [--device cpu]

The torch twin of ``examples/amg_galerkin.py``: builds a 2D-Laplacian fine
grid, aggregates a restriction operator, and computes the coarse operator
two ways — sparsity-aware 1D for the left multiplication, then both the 1D
and the outer-product (Algorithm 3) variants for the right — reproducing
the paper's Fig. 12 comparison. ``galerkin_product``'s host backend, as in
the reference; ``--device`` is taken for a command line like the other
twins' and nothing here runs on it. ``main`` returns the printed numbers.
"""

import argparse

import numpy as np

from repro_torch.apps import galerkin_product
from repro_torch.core import laplacian_2d, restriction_operator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=48)
    ap.add_argument("--coarsening", type=int, default=36)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    a = laplacian_2d(args.side)                # 2304-dof Poisson matrix
    r = restriction_operator(a, coarsening=args.coarsening)
    print(f"fine: {a.shape} nnz={a.nnz};  R: {r.shape} nnz={r.nnz}")

    out = {"r_nnz": r.nnz}
    for alg in ("outer", "1d"):
        res = galerkin_product(a, r=r, nparts=8, right_algorithm=alg)
        print(f"right={alg:5s}: coarse {res.coarse.shape} "
              f"nnz={res.coarse.nnz}, left {res.left_bytes / 1024:.1f} KiB, "
              f"right {res.right_bytes / 1024:.1f} KiB")
        out[alg] = (res.coarse.nnz, res.left_bytes, res.right_bytes)

    # verify against dense algebra
    res = galerkin_product(a, r=r, nparts=8)
    want = r.to_dense().T @ a.to_dense() @ r.to_dense()
    ok = np.allclose(res.coarse.to_dense(), want, atol=1e-8)
    print(f"coarse operator correct: {ok}")
    out["correct"] = ok
    return out


if __name__ == "__main__":
    main()
