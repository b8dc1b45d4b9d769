"""Hand-written Hopper kernels for the perf-critical compute layers.

bsr_spgemm/  scheduled block-sparse semiring product — the local SpGEMM
             engine of the 1D ring (CUDA C++ for sm_90a, bound with ctypes)

Each kernel ships kernel.py (build, binding and the checked wrapper),
csrc/ (the CUDA source), ref.py (the plain PyTorch version) and ops.py
(the user-facing op). Nothing is compiled at import.
"""
