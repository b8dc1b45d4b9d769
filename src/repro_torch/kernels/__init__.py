"""Hand-written Hopper kernels for the perf-critical compute layers.

bsr_spgemm/       scheduled block-sparse semiring product — the local SpGEMM
                  engine of the 1D ring
flash_attention/  causal online-softmax attention forward — LM prefill
moe_gemm/         grouped expert GEMM — every MoE expert FFN

All three are CUDA C++ for sm_90a, bound with ctypes. Each kernel ships
kernel.py (build, binding and the checked wrapper), csrc/ (the CUDA
source), ref.py (the plain PyTorch version) and ops.py (the user-facing
op). ``cuda_lib.py`` builds the sources with nvcc at first use (in
parallel when asked for several) and holds the shared argument checks.
Nothing is compiled at import.
"""
