"""Hopper CUDA kernels: causal online-softmax attention forward.

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
Two routes, chosen by :func:`route` from the dtype and the head dim:

* ``"tc"`` — bfloat16, any head dim D that is a multiple of 8 up to 256,
  ``csrc/flash_attention_tc.cu``: one CTA per (128 query rows, head,
  batch); a producer warpgroup loads Q once and keeps a TMA ring of K and
  V blocks in flight; two consumer warpgroups run ``wgmma`` for QKᵀ (both
  operands in shared memory) and for PV (P rounded to bf16 in registers),
  with the online softmax in fp32 registers. The head dim is processed at
  D rounded up to 64: TMA zero-fills the columns past D.
* ``"fp32"`` — float32, the same head dims, ``csrc/flash_attention_tf32.cu``:
  the same producer / consumer design on split-TF32 ``wgmma`` at float32
  accuracy: q, k, v and p are split into TF32 hi and lo and each product
  sums lo·hi + hi·lo + hi·hi in fp32 (``ref.attention_tf32_model`` is its
  arithmetic on the CPU). V is transposed and split into a K-major Vᵀ in
  shared memory, since TF32 ``wgmma`` has no transpose bit. A key block
  whose largest |k| and the CTA's largest |q| hold an inf or a NaN, reach
  ``2**127``, or multiply to ``2**126`` or more (where hi·hi could overflow;
  ``hopper.cuh::unsplit_panel``) takes its QKᵀ unsplit in IEEE fp32 on the
  CUDA cores. The head dim is processed at D rounded up to 32 (224 to 256,
  :func:`fp32_config`).

The routes' predecessor, ``csrc/flash_attention.cu`` (fp32 FMAs on the
CUDA cores, D rounded up to 64, float32 and bf16), is launched only by
:func:`_launch_cuda_core`, for timings beside either route.

All three read the model layout (B, S, H, D) in place: a query head reads kv
head ``h // rep`` (GQA), keys past S are masked instead of padded, and only
the key blocks between the window's first reachable block and the causal
frontier are read.

Build and binding: ``..cuda_lib`` compiles the three sources for
``sm_90a`` at first use, one ``nvcc`` each, and ``ctypes`` loads them. The
tensor-core libraries encode their TMA tensor maps per launch with the CUDA
driver API's ``cuTensorMapEncodeTiled``, reached through
``cudaGetDriverEntryPoint``.
Nothing is compiled or loaded at import.

:func:`flash_attention` is the wrapper. A tensor on the CPU goes to the
plain version (``ref.mha_ref``) because it lies on the CPU; a CUDA tensor
launches its route's kernel on the current stream or raises — there is no
fallback to another route or to the plain version.
``flash_attention.launches`` counts kernel launches,
``flash_attention.route_launches`` the same per route.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from ..cuda_lib import check_tensor, compile_sources
from .ref import mha_ref

__all__ = ["flash_attention", "check_launch_args", "route", "build",
           "reset_launches", "tc_smem_bytes", "fp32_config",
           "fp32_kernel_config", "ROUTES", "MAX_D", "SOURCE", "TC_SOURCE",
           "TF32_SOURCE", "SOURCES"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
TC_SOURCE = SOURCE.with_name("flash_attention_tc.cu")
TF32_SOURCE = SOURCE.with_name("flash_attention_tf32.cu")
SOURCES = (SOURCE, TC_SOURCE, TF32_SOURCE)
ROUTES = ("tc", "fp32")
MAX_D = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[Dict[str, ctypes.CDLL]] = None


def build() -> dict:
    """Compile (if not yet built) and load the three kernel libraries; returns
    ``{source: {"path", "seconds", "built", "log"}}`` as
    ``cuda_lib.compile_sources`` does. A failing build raises
    ``RuntimeError`` with nvcc's output."""
    global _lib
    infos = compile_sources(SOURCES)
    if _lib is None:
        core = ctypes.CDLL(infos[SOURCE]["path"])
        core.flash_attention_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_float,
                                    ctypes.c_void_p])
        core.flash_attention_launch.restype = ctypes.c_int
        launch_args = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        tc = ctypes.CDLL(infos[TC_SOURCE]["path"])
        tc.flash_attention_tc_launch.argtypes = launch_args
        tc.flash_attention_tc_launch.restype = ctypes.c_int
        tc.flash_attention_tc_smem_bytes.argtypes = [ctypes.c_int]
        tc.flash_attention_tc_smem_bytes.restype = ctypes.c_int
        tf32 = ctypes.CDLL(infos[TF32_SOURCE]["path"])
        tf32.flash_attention_tf32_launch.argtypes = launch_args
        tf32.flash_attention_tf32_launch.restype = ctypes.c_int
        tf32.flash_attention_tf32_config.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        tf32.flash_attention_tf32_config.restype = None
        _lib = {"cuda_core": core, "tc": tc, "fp32": tf32}
    return infos


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a card runs for attention in ``dtype`` at head dim ``d``:
    ``"tc"`` for bfloat16, ``"fp32"`` for float32, each for d a multiple of
    8 up to :data:`MAX_D`. Raises ``ValueError`` for anything else."""
    names = {torch.bfloat16: "tc", torch.float32: "fp32"}
    if dtype not in names:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16, got "
                         f"{dtype}")
    if not (0 < d <= MAX_D and d % 8 == 0):
        raise ValueError(f"the {str(dtype).split('.')[-1]} kernel takes "
                         f"head dims that are multiples of 8 up to "
                         f"{MAX_D}, got {d}")
    return names[dtype]


def check_launch_args(q, k, v, out) -> None:
    """Raise ``ValueError`` on anything the kernels do not take: a dtype
    or head dim that :func:`route` refuses, dtypes differing between the
    tensors, k/v of another shape than (B, S, Hkv, D) with Hkv dividing Hq,
    out of another shape than q, tensors on another device, non-contiguous
    or not 16-byte aligned (the fp32 kernel reads rows as 16-byte vectors;
    TMA needs 16-byte aligned bases)."""
    if q.dim() != 4:
        raise ValueError(f"q must be 4-D (B, S, H, D), has shape "
                         f"{tuple(q.shape)}")
    route(q.dtype, q.shape[3])
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        check_tensor(name, t, q.dtype, 4, q.device, 16)
    b, s, hq, d = q.shape
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


def _launch(name: str, q, k, v, out, scale, causal, window, softcap) -> None:
    """One launch of route ``name``'s kernel, or of the CUDA-core kernel in
    q's dtype for ``"cuda_core"``; raises on a refused launch."""
    b, s, hq, d = q.shape
    if _lib is None:
        build()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            hq, k.shape[2], float(scale), int(causal), int(window),
            float(softcap), stream)
    if name == "tc":
        err = _lib["tc"].flash_attention_tc_launch(d, *args)
    elif name == "fp32":
        err = _lib["fp32"].flash_attention_tf32_launch(d, *args)
    else:
        err = _lib["cuda_core"].flash_attention_launch(_DTYPE_CODE[q.dtype],
                                                       d, *args)
    if err != 0:
        raise RuntimeError(f"flash_attention {name} launch failed: error "
                           f"{err}")


def tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one ``"tc"`` launch at head dim ``d``
    (ptxas reports only static shared memory)."""
    if _lib is None:
        build()
    return _lib["tc"].flash_attention_tc_smem_bytes(d)


def fp32_config(d: int) -> dict:
    """The ``"fp32"`` kernel's blocking at head dim ``d``, as its ``Cfg``
    sets it: the padded head dim ``dp`` (d rounded up to 32, 224 to 256),
    query rows ``bq`` and keys ``bk`` per block. Host arithmetic only; the
    chip run holds it against :func:`fp32_kernel_config`."""
    dp = -(-d // 32) * 32
    dp = 256 if dp == 224 else dp
    bk = 64 if dp <= 64 else 32 if dp <= 192 else 16
    return {"dp": dp, "bq": 128 if dp <= 128 else 64, "bk": bk}


def fp32_kernel_config(d: int) -> dict:
    """What the built ``"fp32"`` library reports for head dim ``d``:
    :func:`fp32_config`'s keys and the launch's dynamic shared memory
    (ptxas reports only static shared memory)."""
    if _lib is None:
        build()
    out = (ctypes.c_int * 4)()
    _lib["fp32"].flash_attention_tf32_config(d, out)
    return {"dp": out[0], "bq": out[1], "bk": out[2], "smem_bytes": out[3]}


def _launch_cuda_core(q, k, v, *, scale: float, causal: bool = True,
                      window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """The CUDA-core kernel on bf16 or float32 CUDA tensors, counted
    nowhere: the predecessor of both routes, kept so a timing can set it
    beside either on one card."""
    out = torch.empty_like(q)
    check_launch_args(q, k, v, out)
    if q.numel():
        _launch("cuda_core", q, k, v, out, scale, causal, window, softcap)
    return out


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
    if q.numel() == 0:
        return out
    name = route(q.dtype, q.shape[3])
    _launch(name, q, k, v, out, scale, causal, window, softcap)
    flash_attention.launches += 1
    flash_attention.route_launches[name] += 1
    return out


def reset_launches() -> None:
    """Set ``flash_attention.launches`` and every route's count to 0."""
    flash_attention.launches = 0
    flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


reset_launches()
