"""Hopper CUDA kernel: causal online-softmax attention forward.

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
The source is ``csrc/flash_attention.cu``: one CTA per (64-row query block,
head, batch) that loops over 64-key blocks only inside the causal frontier
and the sliding window, with Q and each K/V tile in shared memory and m, l
and the output accumulator in fp32 registers. It reads the model layout
(B, S, H, D) directly: a query head reads kv head ``h // rep`` (GQA), keys
past S are masked instead of padded. At qwen2-moe's prefill it is bound by
operations, done as fp32 FMAs on the CUDA cores (see the source's header).

Build and binding: ``..cuda_lib`` compiles the source for ``sm_90a`` at
first use and ``ctypes`` loads it. Nothing is compiled or loaded at import.

:func:`flash_attention` is the wrapper. A tensor on the CPU goes to the
plain version (``ref.mha_ref``) because it lies on the CPU; a CUDA tensor
launches the kernel on the current stream or raises — there is no fallback
from the kernel to the plain version. ``flash_attention.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..cuda_lib import check_tensor, compile_source
from .ref import mha_ref

__all__ = ["flash_attention", "check_launch_args", "build", "KERNEL_D",
           "SOURCE"]

KERNEL_D = (64, 128, 256)
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
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
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return info


def check_launch_args(q, k, v, out) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: a dtype
    other than float32/bfloat16 or differing between the tensors, a head
    dim outside :data:`KERNEL_D`, k/v of another shape than (B, S, Hkv, D)
    with Hkv dividing Hq, out of another shape than q, tensors on another
    device, non-contiguous or not 16-byte aligned (rows are read as 16-byte
    vectors)."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        check_tensor(name, t, q.dtype, 4, q.device, 16)
    b, s, hq, d = q.shape
    if d not in KERNEL_D:
        raise ValueError(f"the CUDA kernel takes head dim in {KERNEL_D}, "
                         f"got {d}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in (B, S, D)")
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hkv} kv heads do not divide {hq} query heads")
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} != q {tuple(q.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, Hq, D), k and v (B, S, Hkv, D) -> (B, S, Hq, D) in q's dtype.

    ``window`` is the sliding-window width in tokens (0 = full), ``softcap``
    the logit cap (0 = none).
    """
    if not q.is_cuda:
        return mha_ref(q, k, v, scale=scale, causal=causal, window=window,
                       softcap=softcap)
    out = torch.empty_like(q)
    check_launch_args(q, k, v, out)
    b, s, hq, d = q.shape
    if q.numel() == 0:
        return out
    if _lib is None:
        build()
    err = _lib.flash_attention_launch(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, hq, k.shape[2], float(scale), int(causal),
        int(window), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
