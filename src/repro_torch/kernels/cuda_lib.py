"""Build and argument-check helpers shared by the hand-written CUDA kernels.

Each kernel's source (``<kernel>/csrc/<kernel>.cu``) has a plain C
interface. At first use ``nvcc`` compiles it for ``sm_90a`` into a shared
library under the repo's ``build/`` directory, named by a hash of the
source, the headers it includes by quoted path and the flags, so an
edited source, header or flag set builds anew and an unchanged one is
reused. The caller loads the library with ``ctypes``. Nothing here runs at
import.

:func:`compile_sources` starts one ``nvcc`` per source, all at once, and
waits for every one: the kernels of a run build in parallel. A build holds
an exclusive lock on ``build/.lock`` (``fcntl.flock``, released when the
process ends, however it ends), so processes that start together — the
ranks of one job — build each library once: the first builds, the others
wait and find it built.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "local_headers", "library_path",
           "compile_sources", "check_tensor"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def local_headers(source: Path) -> List[Path]:
    """The headers ``source`` includes by quoted path (``#include "..."``),
    each resolved against the directory of the file that includes it, and
    the headers those include in turn, in the order first met."""
    found: List[Path] = []
    todo = [Path(source)]
    while todo:
        current = todo.pop()
        for name in _INCLUDE.findall(current.read_text()):
            header = (current.parent / name).resolve()
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives: ``build/<stem>-<hash
    of source, its local headers and flags>.so``, with nvcc's report beside
    it as ``.log``."""
    digest = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def compile_sources(sources: Sequence[Path]) -> Dict[Path, dict]:
    """Build every source whose library is missing, one ``nvcc`` each, all
    started together. Returns, per source, ``{"path", "seconds", "built",
    "log"}``: the library, the wall time of this call, whether ``nvcc`` ran,
    and ptxas's report (registers, shared memory, spills per kernel). A
    failing build raises ``RuntimeError`` with nvcc's output, after every
    started ``nvcc`` has ended."""
    t0 = time.perf_counter()
    running = {}
    if not all(library_path(src).exists() for src in sources):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            running = _build_missing(sources)
    seconds = time.perf_counter() - t0
    info = {}
    for src in sources:
        log = library_path(src).with_suffix(".log")
        info[src] = {"path": str(library_path(src)), "seconds": seconds,
                     "built": src in running,
                     "log": log.read_text() if log.exists() else ""}
    return info


def _build_missing(sources: Sequence[Path]) -> dict:
    """Start one ``nvcc`` for each source whose library is missing, wait
    for all, and move each library into place; the caller holds the build
    lock. Returns the sources built."""
    running = {}
    for src in sources:
        so = library_path(src)
        if so.exists() or src in running:
            continue
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
    return running


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
