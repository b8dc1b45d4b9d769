"""Hopper CUDA kernel: scheduled block-sparse semiring product.

Replaces ``src/repro/kernels/bsr_spgemm/kernel.py::bsr_spgemm_pallas``. The
source is ``csrc/bsr_spgemm.cu`` (one CTA per run of products sharing an
output tile, the accumulator in registers; see its header for the design).
It is compute-bound on fp32 CUDA-core FMAs at bs=128.

Build and binding: at first use ``nvcc`` compiles the source for
``sm_90a`` into a shared library with a plain C interface under the repo's
``build/`` directory, named by a hash of the source and the flags, and
``ctypes`` loads it. Nothing is compiled or loaded at import.

:func:`bsr_spgemm` is the wrapper. A tensor on the CPU goes to the plain
version (``ref.bsr_spgemm_ref``) because it lies on the CPU; a CUDA tensor
launches the kernel on the current stream or raises — there is no fallback
from the kernel to the plain version. ``bsr_spgemm.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...core.semiring import PLUS_TIMES, Semiring
from .ref import bsr_spgemm_ref

__all__ = ["bsr_spgemm", "run_starts_from_flags", "check_launch_args",
           "build", "KERNEL_BS", "SOURCE", "BUILD_DIR"]

KERNEL_BS = (16, 32, 64, 128)
SOURCE = Path(__file__).resolve().parent / "csrc" / "bsr_spgemm.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_SEMIRING_CODE = {"plus_times": 0, "bool_or_and": 1, "min_plus": 2}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the bsr_spgemm kernel is built "
                       "from source at first use and needs the CUDA toolkit")


def build() -> dict:
    """Compile (if not yet built) and load the kernel library.

    Returns ``{"path", "seconds", "built", "log"}``: the shared library,
    the wall time of this call, whether ``nvcc`` ran, and ptxas's report
    (registers, shared memory, spills per instantiation). A failing build
    raises ``RuntimeError`` with nvcc's output.
    """
    global _lib
    t0 = time.perf_counter()
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"bsr_spgemm-{tag}.so"
    log = so.with_suffix(".log")
    built = False
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {SOURCE}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
        built = True
    if _lib is None:
        lib = ctypes.CDLL(str(so))
        fn = lib.bsr_spgemm_launch
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return {"path": str(so), "seconds": time.perf_counter() - t0,
            "built": built, "log": log.read_text() if log.exists() else ""}


def run_starts_from_flags(flags: np.ndarray, seg_start: int,
                          nprod: int) -> np.ndarray:
    """Host-side run boundaries of one schedule window, once per plan.

    The products of a window ``[seg_start, seg_start + nprod)`` that share
    an output slot are one run; a run starts where flags bit 0 (first
    visit) is set. Returns the ``nruns + 1`` absolute positions of the run
    starts followed by the window's end, as int32. The window's first
    product always starts a run.
    """
    f = np.asarray(flags)[seg_start:seg_start + nprod]
    starts = np.flatnonzero(f & 1)
    if nprod and (len(starts) == 0 or starts[0] != 0):
        starts = np.concatenate([[0], starts])
    return (np.concatenate([starts, [nprod]]) + seg_start).astype(np.int32)


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device,
           align: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, has shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def check_launch_args(a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts,
                      out, *, nprod: int, nc: int, bs: int,
                      semiring: Semiring, seg_start: int) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: bs
    outside :data:`KERNEL_BS`, an unknown semiring, tensors on another
    device, of another dtype or shape, non-contiguous, or misaligned (tile
    stacks are read as float4, so 16 bytes; index arrays 4)."""
    if bs not in KERNEL_BS:
        raise ValueError(f"the CUDA kernel takes bs in {KERNEL_BS}, got {bs}")
    if semiring.name not in _SEMIRING_CODE:
        raise ValueError(f"no kernel instantiation for semiring "
                         f"{semiring.name!r}")
    dev = a_tiles.device
    for name, t in (("a_tiles", a_tiles), ("b_tiles", b_tiles),
                    ("out", out)):
        _check(name, t, torch.float32, 3, dev, 16)
        if tuple(t.shape[1:]) != (bs, bs):
            raise ValueError(f"{name} has tiles of shape "
                             f"{tuple(t.shape[1:])}, expected {(bs, bs)}")
    if out.shape[0] != nc:
        raise ValueError(f"out holds {out.shape[0]} tiles, expected {nc}")
    for name, t in (("a_slot", a_slot), ("b_slot", b_slot),
                    ("c_slot", c_slot), ("run_starts", run_starts)):
        _check(name, t, torch.int32, 1, dev, 4)
    for name, t in (("a_slot", a_slot), ("b_slot", b_slot),
                    ("c_slot", c_slot)):
        if t.shape[0] < seg_start + nprod:
            raise ValueError(f"{name} has {t.shape[0]} entries, the window "
                             f"needs {seg_start + nprod}")
    if run_starts.shape[0] < 1:
        raise ValueError("run_starts must hold at least the window end")


def bsr_spgemm(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
               a_slot: torch.Tensor, b_slot: torch.Tensor,
               c_slot: torch.Tensor, run_starts: torch.Tensor, *,
               nprod: int, nc: int, bs: int,
               semiring: Semiring = PLUS_TIMES, seg_start: int = 0,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the product schedule window; returns ``(nc, bs, bs)`` payloads.

    a_tiles / b_tiles : (na, bs, bs), (nb, bs, bs) float32 payload stacks
        whose absent positions hold ``semiring.zero``
    a_slot / b_slot / c_slot : int32 schedule arrays of length
        ``>= seg_start + nprod``; products ``[seg_start, seg_start+nprod)``
        run, ``c_slot`` nondecreasing over the window
    run_starts : int32 ``run_starts_from_flags(flags, seg_start, nprod)``
        on the same device (the plain version does not read it)
    out : optional ``(nc, bs, bs)`` float32 destination

    The output is filled with ``semiring.zero`` first, so slots no product
    visits hold the identity. ``nprod == 0`` returns a ``(max(nc, 1), bs,
    bs)`` identity fill.
    """
    if out is None:
        out = torch.full((max(nc, 1) if nprod == 0 else nc, bs, bs),
                         semiring.zero, dtype=torch.float32,
                         device=a_tiles.device)
    else:
        out.fill_(semiring.zero)
    if nprod == 0:
        return out
    if not a_tiles.is_cuda:
        out.copy_(bsr_spgemm_ref(a_tiles, b_tiles, a_slot, b_slot, c_slot,
                                 nc=nc, semiring=semiring,
                                 seg_start=seg_start, seg_len=nprod))
        return out

    check_launch_args(a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts,
                      out, nprod=nprod, nc=nc, bs=bs, semiring=semiring,
                      seg_start=seg_start)
    nruns = run_starts.shape[0] - 1
    if nruns == 0:  # only pad products in the window: nothing to launch
        return out
    if _lib is None:
        build()
    err = _lib.bsr_spgemm_launch(
        _SEMIRING_CODE[semiring.name], bs, a_tiles.data_ptr(),
        b_tiles.data_ptr(), a_slot.data_ptr(), b_slot.data_ptr(),
        c_slot.data_ptr(), run_starts.data_ptr(), nruns, out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bsr_spgemm launch failed: cudaError_t {err}")
    bsr_spgemm.launches += 1
    return out


bsr_spgemm.launches = 0
