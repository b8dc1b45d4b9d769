"""Core: the paper's contribution — sparsity-aware 1D SpGEMM.

Layers (each the counterpart of the ``repro.core`` module of that name):
  sparse.py        element-level CSC/DCSC substrate + generators (numpy)
  semiring.py      plus-times / boolean / tropical semirings (numpy + torch)
  local_spgemm.py  vectorized Gustavson local multiply (the oracle)
  plan.py          Algorithms 1-2 symbolic phase: hit vectors, block fetch
  spgemm_1d.py     Algorithm 1 execution (host path, per-process oracle)
  blocksparse.py   block-sparse tiles (device payloads) + product schedules
  device_common.py shared device-engine machinery (blockize/pack/decode/stats)
  spgemm_1d_device.py  the 1D ring on one CUDA device
  validate.py      ingress validation + typed error taxonomy
  session.py       persistent SpGEMM sessions: structure-keyed LRU cache of
                   plans + built ring executables
  convert.py       builds port objects from the reference's plain arrays
"""

from .semiring import BOOL_OR_AND, MIN_PLUS, PLUS_TIMES, Semiring, by_name
from .sparse import (CSC, banded_clustered, erdos_renyi, from_coo,
                     laplacian_2d, rmat, symmetrize)
from .local_spgemm import spgemm, spgemm_flops
from .plan import BYTES_PER_NNZ, FetchPlan, Partition1D, build_fetch_plan
from .spgemm_1d import SpGEMM1DResult, spgemm_1d
from .session import SpGEMMSession, structure_fingerprint
from .validate import (DeviceExecError, PlanError, SpGEMMError,
                       ValidationError, validate_csc,
                       validate_matmul_operands)
