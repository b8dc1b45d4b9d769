"""Build and argument-check helpers shared by the hand-written CUDA kernels.

Each kernel's source (``<kernel>/csrc/<kernel>.cu``) has a plain C
interface. At first use ``nvcc`` compiles it for ``sm_90a`` into a shared
library under the repo's ``build/`` directory, named by a hash of the
source and the flags, so an edited source or flag set builds anew and an
unchanged one is reused. The caller loads the library with ``ctypes``.
Nothing here runs at import.

:func:`compile_sources` starts one ``nvcc`` per source, all at once, and
waits for every one: the kernels of a run build in parallel.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "library_path", "compile_sources",
           "compile_source", "check_tensor"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives: ``build/<stem>-<hash
    of source and flags>.so``, with nvcc's report beside it as ``.log``."""
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{tag}.so"


def compile_sources(sources: Sequence[Path]) -> Dict[Path, dict]:
    """Build every source whose library is missing, one ``nvcc`` each, all
    started together. Returns, per source, ``{"path", "seconds", "built",
    "log"}``: the library, the wall time of this call, whether ``nvcc`` ran,
    and ptxas's report (registers, shared memory, spills per kernel). A
    failing build raises ``RuntimeError`` with nvcc's output, after every
    started ``nvcc`` has ended."""
    t0 = time.perf_counter()
    running = {}
    for src in sources:
        so = library_path(src)
        if so.exists() or src in running:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        running[src] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (so, tmp, proc) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src}:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    info = {}
    for src in sources:
        log = library_path(src).with_suffix(".log")
        info[src] = {"path": str(library_path(src)), "seconds": seconds,
                     "built": src in running,
                     "log": log.read_text() if log.exists() else ""}
    return info


def compile_source(source: Path) -> dict:
    """:func:`compile_sources` for one source."""
    return compile_sources([source])[source]


def check_tensor(name: str, t: torch.Tensor, dtype, ndim: int, device,
                 align: int) -> None:
    """Raise ``ValueError`` unless ``t`` lies on ``device``, has ``dtype``
    and ``ndim`` dimensions, is contiguous and starts on an ``align``-byte
    boundary (what a kernel's vector loads need)."""
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
