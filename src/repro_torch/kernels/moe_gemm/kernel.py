"""Hopper CUDA kernels: grouped expert GEMM ``y[e] = x[e] @ w[e]``.

Replaces ``src/repro/kernels/moe_gemm/kernel.py::moe_gemm_pallas``. Three
routes, chosen by :func:`route` from the dtype and ``cap``:

* ``"prefill"`` — bfloat16 with cap > 16, ``csrc/moe_gemm_tc.cu``:
  128 x 128 tiles on ``wgmma`` (bf16 in, fp32 accumulate), fed by a TMA
  ring of 64-deep k-panels from a producer warp.
* ``"decode"`` — bfloat16 with cap <= 16, ``csrc/moe_gemm_tc.cu``: a
  weight-streaming kernel that reads only the weights of experts with a
  live row, on ``mma.sync``, its K splits reduced in a fixed order inside a
  thread-block cluster.
* ``"fp32"`` — float32, ``csrc/moe_gemm.cu``: fp32 FMAs on the CUDA cores,
  so integer-valued inputs stay bitwise equal to the plain version.

``rows`` (int32, (E,), on x's device, or None for every row) is each
expert's count of live rows, clamped to ``[0, cap]`` on the device: rows
``r >= rows[e]`` of ``y[e]`` are written as zeros, and no kernel reads their
x rows or forms their products. Every kernel predicates its edges, so no
operand is padded or copied, and the contraction runs over all of d (the
Pallas kernel drops the last ``d % 512`` columns when d is not a multiple
of 512; these do not).

Build and binding: ``..cuda_lib`` compiles both sources for ``sm_90a`` at
first use, one ``nvcc`` each, and ``ctypes`` loads them. The tensor-core
library encodes its TMA tensor maps per launch with the CUDA driver API's
``cuTensorMapEncodeTiled``, reached through ``cudaGetDriverEntryPoint``.
Nothing is compiled or loaded at import.

:func:`moe_gemm` is the wrapper. A tensor on the CPU goes to the plain
version (``ref.moe_gemm_ref``) because it lies on the CPU; a CUDA tensor
launches its route's kernel on the current stream or raises — there is no
fallback to another route or to the plain version. ``moe_gemm.launches``
counts kernel launches, ``moe_gemm.route_launches`` the same per route.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from ..cuda_lib import check_tensor, compile_sources
from .ref import moe_gemm_ref

__all__ = ["moe_gemm", "check_launch_args", "block_rows", "route", "build",
           "reset_launches", "tc_smem_bytes", "ROUTES", "SOURCE", "TC_SOURCE",
           "SOURCES", "DECODE_MAX_CAP"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gemm.cu"
TC_SOURCE = SOURCE.with_name("moe_gemm_tc.cu")
SOURCES = (SOURCE, TC_SOURCE)
ROUTES = ("prefill", "decode", "fp32")
DECODE_MAX_CAP = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[Dict[str, ctypes.CDLL]] = None


def build() -> dict:
    """Compile (if not yet built) and load both kernel libraries; returns
    ``{source: {"path", "seconds", "built", "log"}}`` as
    ``cuda_lib.compile_sources`` does. A failing build raises
    ``RuntimeError`` with nvcc's output."""
    global _lib
    infos = compile_sources(SOURCES)
    if _lib is None:
        fp32 = ctypes.CDLL(infos[SOURCE]["path"])
        fp32.moe_gemm_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fp32.moe_gemm_launch.restype = ctypes.c_int
        tc = ctypes.CDLL(infos[TC_SOURCE]["path"])
        tc.moe_gemm_tc_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        tc.moe_gemm_tc_launch.restype = ctypes.c_int
        tc.moe_gemm_tc_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        tc.moe_gemm_tc_smem_bytes.restype = ctypes.c_int
        _lib = {"fp32": fp32, "tc": tc}
    return infos


def route(dtype: torch.dtype, cap: int) -> str:
    """The kernel a card runs for a grouped GEMM of ``dtype`` with ``cap``
    slots per expert: ``"fp32"`` for float32, ``"decode"`` for bfloat16
    with cap <= 16, ``"prefill"`` for bfloat16 above. Raises
    ``ValueError`` for any other dtype."""
    if dtype == torch.float32:
        return "fp32"
    if dtype == torch.bfloat16:
        return "decode" if cap <= DECODE_MAX_CAP else "prefill"
    raise ValueError(f"the CUDA kernels take float32 or bfloat16, got "
                     f"{dtype}")


def block_rows(cap: int) -> int:
    """Rows of the fp32 kernel's M tile for a capacity of ``cap`` slots: 16
    for cap <= 16, 64 for cap <= 64, 128 above."""
    return 16 if cap <= 16 else 64 if cap <= 64 else 128


def check_launch_args(x, w, out, rows=None) -> None:
    """Raise ``ValueError`` on anything the kernels do not take: a dtype
    other than float32/bfloat16 or differing between the tensors, shapes
    other than x (E, cap, d), w (E, d, f), out (E, cap, f), d or f not a
    multiple of 8 (rows are read as 16-byte vectors and TMA strides are
    16-byte multiples), tensors on another device, non-contiguous or not
    16-byte aligned; ``rows`` other than None or a contiguous int32 (E,)
    tensor on x's device."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16, got "
                         f"{x.dtype}")
    for name, t in (("x", x), ("w", w), ("out", out)):
        check_tensor(name, t, x.dtype, 3, x.device, 16)
    e, cap, d = x.shape
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    f = w.shape[2]
    if d % 8 or f % 8:
        raise ValueError(f"the CUDA kernels take d and f in multiples of 8, "
                         f"got d={d}, f={f}")
    if tuple(out.shape) != (e, cap, f):
        raise ValueError(f"out {tuple(out.shape)} != {(e, cap, f)}")
    if rows is not None:
        check_tensor("rows", rows, torch.int32, 1, x.device, 4)
        if rows.shape[0] != e:
            raise ValueError(f"rows has {rows.shape[0]} entries for {e} "
                             f"experts")


def _launch(name: str, x, w, rows, out) -> None:
    """One launch of route ``name``'s kernel; raises on a refused launch."""
    e, cap, d = x.shape
    f = w.shape[2]
    if _lib is None:
        build()
    rows_ptr = None if rows is None else rows.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == "fp32":
        err = _lib["fp32"].moe_gemm_launch(
            _DTYPE_CODE[x.dtype], block_rows(cap), x.data_ptr(), w.data_ptr(),
            rows_ptr, out.data_ptr(), e, cap, d, f, stream)
    else:
        err = _lib["tc"].moe_gemm_tc_launch(
            int(name == "decode"), x.data_ptr(), w.data_ptr(), rows_ptr,
            out.data_ptr(), e, cap, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm {name} launch failed: error {err}")


def tc_smem_bytes(name: str, d: int) -> int:
    """Dynamic shared memory of one launch of the ``"prefill"`` or
    ``"decode"`` route's kernel at contraction depth ``d`` (ptxas reports
    only static shared memory)."""
    if _lib is None:
        build()
    return _lib["tc"].moe_gemm_tc_smem_bytes(int(name == "decode"), d)


def _launch_cuda_core(x: torch.Tensor, w: torch.Tensor,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fp32 CUDA-core kernel on bf16 or float32 CUDA tensors, counted
    nowhere: the tensor-core routes' predecessor for bf16, kept so a timing
    can set the two side by side on one card."""
    out = torch.empty((x.shape[0], x.shape[1], w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    check_launch_args(x, w, out, rows)
    if out.numel() and x.shape[2]:
        _launch("fp32", x, w, rows, out)
    elif out.numel():
        out.zero_()
    return out


def moe_gemm(x: torch.Tensor, w: torch.Tensor,
             rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, cap, d), w (E, d, f) -> (E, cap, f) in x's dtype, with fp32
    accumulation over all of d; rows ``r >= rows[e]`` are zeros."""
    if not x.is_cuda:
        return moe_gemm_ref(x, w, rows)
    out = torch.empty((x.shape[0], x.shape[1], w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    check_launch_args(x, w, out, rows)
    if out.numel() == 0:
        return out
    if x.shape[2] == 0:
        return out.zero_()
    name = route(x.dtype, x.shape[1])
    _launch(name, x, w, rows, out)
    moe_gemm.launches += 1
    moe_gemm.route_launches[name] += 1
    return out


def reset_launches() -> None:
    """Set ``moe_gemm.launches`` and every route's count to 0."""
    moe_gemm.launches = 0
    moe_gemm.route_launches = dict.fromkeys(ROUTES, 0)


reset_launches()
