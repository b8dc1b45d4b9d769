"""Hopper CUDA kernel: grouped expert GEMM ``y[e] = x[e] @ w[e]``.

Replaces ``src/repro/kernels/moe_gemm/kernel.py::moe_gemm_pallas``. The
source is ``csrc/moe_gemm.cu``: one CTA per (128-column N tile, BM-row M
tile, expert), k-panels of x and w staged through shared memory with the
next panel prefetched into registers, an fp32 accumulator in registers,
and predicated edges, so no operand is padded or copied. The contraction
runs over all of d (the Pallas kernel drops the last ``d % 512`` columns
when d is not a multiple of 512; this one does not).

The M tile follows ``cap`` (:func:`block_rows`): 16 rows for a decode
step's cap of 8, where the launch is bound by reading the expert weights;
128 rows for prefill's cap in the hundreds, where it is bound by
operations (fp32 FMAs on the CUDA cores).

Build and binding: ``..cuda_lib`` compiles the source for ``sm_90a`` at
first use and ``ctypes`` loads it. Nothing is compiled or loaded at import.

:func:`moe_gemm` is the wrapper. A tensor on the CPU goes to the plain
version (``ref.moe_gemm_ref``) because it lies on the CPU; a CUDA tensor
launches the kernel on the current stream or raises — there is no fallback
from the kernel to the plain version. ``moe_gemm.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..cuda_lib import check_tensor, compile_source
from .ref import moe_gemm_ref

__all__ = ["moe_gemm", "check_launch_args", "block_rows", "build", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gemm.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None


def build() -> dict:
    """Compile (if not yet built) and load the kernel library; returns
    ``{"path", "seconds", "built", "log"}`` as ``cuda_lib.compile_source``
    does. A failing build raises ``RuntimeError`` with nvcc's output."""
    global _lib
    info = compile_source(SOURCE)
    if _lib is None:
        lib = ctypes.CDLL(info["path"])
        fn = lib.moe_gemm_launch
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return info


def block_rows(cap: int) -> int:
    """Rows of the kernel's M tile for a capacity of ``cap`` slots: 16 for
    a decode step (cap <= 16), 64 for cap <= 64, 128 above."""
    return 16 if cap <= 16 else 64 if cap <= 64 else 128


def check_launch_args(x, w, out) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: a dtype
    other than float32/bfloat16 or differing between the tensors, shapes
    other than x (E, cap, d), w (E, d, f), out (E, cap, f), d or f not a
    multiple of 8 (rows are read as 16-byte vectors), tensors on another
    device, non-contiguous or not 16-byte aligned."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    for name, t in (("x", x), ("w", w), ("out", out)):
        check_tensor(name, t, x.dtype, 3, x.device, 16)
    e, cap, d = x.shape
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    f = w.shape[2]
    if d % 8 or f % 8:
        raise ValueError(f"the CUDA kernel takes d and f in multiples of 8, "
                         f"got d={d}, f={f}")
    if tuple(out.shape) != (e, cap, f):
        raise ValueError(f"out {tuple(out.shape)} != {(e, cap, f)}")


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, cap, d), w (E, d, f) -> (E, cap, f) in x's dtype, with fp32
    accumulation over all of d."""
    if not x.is_cuda:
        return moe_gemm_ref(x, w)
    out = torch.empty((x.shape[0], x.shape[1], w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    check_launch_args(x, w, out)
    e, cap, d = x.shape
    f = w.shape[2]
    if out.numel() == 0:
        return out
    if d == 0:
        return out.zero_()
    if _lib is None:
        build()
    err = _lib.moe_gemm_launch(
        _DTYPE_CODE[x.dtype], block_rows(cap), x.data_ptr(), w.data_ptr(),
        out.data_ptr(), e, cap, d, f,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm launch failed: cudaError_t {err}")
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
