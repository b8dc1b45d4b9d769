"""Core: the paper's contribution — sparsity-aware 1D SpGEMM — and the
sparsity-oblivious baselines it is compared against.

Layers (each the counterpart of the ``repro.core`` module of that name):
  sparse.py        element-level CSC/DCSC substrate + generators (numpy)
  semiring.py      plus-times / boolean / tropical semirings (numpy + torch)
  local_spgemm.py  vectorized Gustavson local multiply (the oracle)
  plan.py          Algorithms 1-2 symbolic phase: hit vectors, block-fetch
                   plans, CV/memA, exact 2D/3D comm accounting
  spgemm_1d.py     Algorithm 1 execution (host path, per-process oracle)
  spgemm_outer.py  Algorithm 3 (outer-product 1D, for (R^T A) R)
  spgemm_2d.py     sparse 2D SUMMA baseline (host oracle)
  spgemm_3d.py     Split-3D-SpGEMM baseline (host oracle)
  partition.py     random permutation + METIS-style multilevel partitioner
  blocksparse.py   block-sparse tiles (device payloads) + product schedules
  device_common.py shared device-engine machinery (blockize/pack/decode/stats)
  spgemm_1d_device.py  the 1D ring on one CUDA device
  spgemm_2d_device.py  device sparse SUMMA on one CUDA device (logical grid)
  spgemm_3d_device.py  device Split-3D (layered SUMMA + cross-layer reduce)
  validate.py      ingress validation + typed error taxonomy
  session.py       persistent SpGEMM sessions: structure-keyed LRU cache of
                   plans + built executables across all three engines
  convert.py       builds port objects from the reference's plain arrays
"""

from .semiring import BOOL_OR_AND, MIN_PLUS, PLUS_TIMES, Semiring, by_name
from .sparse import (CSC, banded_clustered, block_diagonal_noise, erdos_renyi,
                     from_coo, from_dense, identity, laplacian_2d,
                     permute_cols, permute_rows, permute_symmetric,
                     restriction_operator, rmat, symmetrize)
from .local_spgemm import spadd, spgemm, spgemm_flops, spgemm_structure
from .plan import (BYTES_PER_NNZ, CommModel, FetchPlan, Partition1D,
                   build_fetch_plan, block_fetch_groups, cv_over_mema,
                   summa2d_comm_volume, summa3d_comm_volume)
from .spgemm_1d import SpGEMM1DResult, spgemm_1d, spgemm_1d_simple
from .spgemm_outer import OuterProductResult, spgemm_outer_1d
from .spgemm_2d import SpGEMM2DResult, spgemm_2d
from .spgemm_3d import SpGEMM3DResult, spgemm_3d
from .spgemm_2d_device import (SummaDevicePlan, build_summa_plan,
                               run_device_summa)
from .spgemm_3d_device import build_summa3d_plan, run_device_summa3d
from .partition import (PartitionReport, degree_squared_weights, edge_cut,
                        multilevel_partition, partition_to_permutation,
                        random_permutation)
from .session import SpGEMMSession, structure_fingerprint
from .validate import (DeviceExecError, PlanError, SpGEMMError,
                       ValidationError, validate_csc,
                       validate_matmul_operands)
