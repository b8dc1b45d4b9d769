"""repro_torch — the PyTorch/CUDA port of ``repro``, the sparsity-aware 1D
SpGEMM (Hong & Buluc 2024), for one NVIDIA H100.

A package beside ``repro`` with the same layout and public names. It imports
torch and numpy only — never jax and nothing of ``repro``. Entry points run
on ``device="cuda"`` unless the caller asks for the CPU, where each kernel's
plain PyTorch version runs instead.
"""

__version__ = "0.1.0"
