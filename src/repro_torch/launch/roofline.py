"""Roofline terms of one rank's step from the H100 dry-run (no card needed).

The port of ``repro.launch.roofline``. Three terms per (arch × shape ×
mesh), in seconds, each a per-rank quantity over a per-card rate:

    compute    = flops                / 989.4 TFLOP/s (dense bf16)
    memory     = bytes_model          / 3.35 TB/s (HBM3)
    collective = collective bytes     / 50 GB/s (the inter-host link)

``HW`` keeps the reference's keys, so records and ``report`` read the same,
with the NVIDIA H100 SXM5 80GB HBM3 data sheet's figures at 700 W (the
card the chip runs read):

  * ``peak_flops`` 989.4e12, dense bf16 on the tensor cores;
  * ``hbm_bw`` 3.35e12;
  * ``ici_bw`` 50e9, the per-card link a production mesh's collectives
    cross: the inter-host network, one 400 Gb/s NDR InfiniBand port per
    card (DGX H100's eight ConnectX-7 for eight cards), 50 GB/s each way.
    NVLink (450 GB/s each way) joins only a host's 8 cards; a ``16x16``
    mesh spans 32 hosts, so a ``model`` line of 16 leaves its host and its
    collectives run at the network's rate.

The port has no HLO to parse. :func:`collective_bytes` builds the
reference's breakdown (``{<kind>: bytes, "count", "total"}``) from the
dry-run comm's counts by kind, whose keys are the port's ``MeshComm``
kinds (``core.collectives.KINDS``: ``"a2a"``, ``"tp"``, ``"fsdp"``, …), not
HLO op names. A kind's bytes are the larger of what the rank sent and what
it received: each direction of a link has its own rate.
:func:`bytes_model` and :func:`model_flops` are the reference's formulas,
unchanged (the port keeps its own copy).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..core.collectives import KINDS

__all__ = ["HW", "Roofline", "collective_bytes", "analyze", "model_flops",
           "bytes_model"]

# NVIDIA H100 SXM5 80GB HBM3, one card, data sheet at 700 W
PEAK_FLOPS = 989.4e12      # dense bf16, tensor cores
HBM_BW = 3.35e12           # bytes/s
ICI_BW = 50e9              # bytes/s each way: one 400 Gb/s NDR port a card

HW = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "ici_bw": ICI_BW}


def collective_bytes(counts: dict) -> Dict[str, int]:
    """The reference's collective breakdown from a ``MeshComm``'s counts:
    ``counts["sent"]`` / ``counts["received"]`` (bytes by kind) and
    ``counts["calls"]`` (collectives by kind). Per kind the larger of the
    bytes sent and received, ``"count"`` the calls, ``"total"`` the sum of
    the kinds."""
    out: Dict[str, int] = {
        k: int(max(counts["sent"].get(k, 0), counts["received"].get(k, 0)))
        for k in KINDS}
    out["count"] = int(sum(counts["calls"].values()))
    out["total"] = sum(out[k] for k in KINDS)
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities
    flops_per_device: float
    bytes_per_device: float          # analytic HBM model (see bytes_model)
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    # usefulness
    model_flops: float            # 6ND (train) / 2ND (inference), global
    peak_memory_bytes: Optional[float] = None
    bytes_hlo: float = 0.0        # every op's reads and writes, unfused

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achieved fraction of the compute roofline: time the *useful*
        (model) flops would take at the H100's peak, over the bound
        time."""
        if self.bound_time == 0:
            return 0.0
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return t_useful / self.bound_time

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_dev": self.flops_per_device,
            "bytes_dev": self.bytes_per_device,
            "bytes_hlo_dev": self.bytes_hlo,
            "coll_dev": self.coll_bytes_per_device,
            "t_compute_ms": self.t_compute * 1e3,
            "t_memory_ms": self.t_memory * 1e3,
            "t_collective_ms": self.t_collective * 1e3,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_frac": self.roofline_fraction,
            "peak_memory_gb": (self.peak_memory_bytes or 0) / 2**30,
        }


def bytes_model(cfg, shape, *, tp: int = 16, batch_shards: int = 16,
                chips: int = 256) -> float:
    """Analytic per-device HBM traffic model (bytes per step), the
    reference's.

    The dry-run's own count of every op's reads and writes (``bytes_hlo``)
    charges every unfused intermediate of the plain versions (the
    attention's whole logit matrix among them), which the card's kernels
    keep in shared memory and registers; the memory *term* therefore uses
    this napkin model of what transits HBM. Terms:

      weights   : fwd (+ remat re-read + bwd) passes over the TP shard, bf16
      optimizer : AdamW on the FSDP shard — p,g,m,v reads + p,m,v writes, f32
      grads     : produce + reduce read of the TP grad shard, f32
      activs    : c_act passes of (tokens_dev × d_model) per layer, bf16
                  (c_act ≈ 8 fwd, ×2.5 with remat+bwd for training)
      logits    : chunked-CE logit tiles, f32 write+read (+bwd recompute)
      kv_cache  : decode reads the seq-sharded cache once per step; prefill
                  writes it once; GQA repeat charged at query-head width
      q_stream  : chunked attention re-reads Q once per kv chunk
    """
    n_total = cfg.param_count()
    is_train = shape.kind == "train"
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    bsh = batch_shards if shape.global_batch % batch_shards == 0 else 1
    t_dev = tokens / bsh
    d = cfg.d_model

    n_tp = n_total / tp
    weights = (3 if is_train else 1) * 2.0 * n_tp
    opt = 32.0 * (n_total / chips) if is_train else 0.0
    grads = 8.0 * (n_total / tp) if is_train else 0.0

    c_act = 20.0 if is_train else 8.0
    activs = c_act * t_dev * d * 2.0 * cfg.n_layers

    logits = (12.0 if is_train else 4.0) * t_dev * (cfg.vocab / tp)

    n_attn = sum(1 for k in cfg.pattern if k in "aAl") * cfg.n_periods
    kv = 0.0
    q_stream = 0.0
    if n_attn and cfg.has_attention:
        hkv_w = cfg.n_kv_heads * cfg.hd
        if shape.kind == "decode":
            # grouped-GQA decode reads the (seq-sharded) cache once at
            # KV-head width (attention.py:attn_decode — no repeat)
            kv = (shape.global_batch * shape.seq_len *
                  hkv_w * 2.0 / max(bsh, 1) / tp) * n_attn
        else:
            kv = t_dev * hkv_w * 2.0 * n_attn            # write once
            nk = max(shape.seq_len // cfg.attn_chunk, 1)
            q_stream = (t_dev * cfg.n_heads * cfg.hd * 2.0 * nk
                        * (2.5 if is_train else 1.0) * n_attn / tp)

    return weights + opt + grads + activs + logits + kv + q_stream


def model_flops(cfg, shape) -> float:
    """6·N·D for training, 2·N·D forward-only; N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def analyze(cost: dict, cfg, shape_cfg, mesh_name: str, chips: int,
            arch: str) -> Roofline:
    """A :class:`Roofline` from the dry-run's ``cost`` of one rank's step
    (``launch.dryrun.run_step``): ``"flops"``, ``"bytes accessed"``, the
    comm's ``"sent"`` / ``"received"`` / ``"calls"`` and ``"peak"`` (live
    bytes), where the reference reads a compiled executable. As there,
    the memory term here is the counted bytes; ``dryrun.lower_cell`` uses
    :func:`bytes_model` instead."""
    flops = float(cost["flops"])
    byts = float(cost["bytes accessed"])
    coll = collective_bytes(cost)
    return Roofline(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops,
        bytes_per_device=byts,
        coll_bytes_per_device=float(coll["total"]),
        coll_breakdown=coll,
        t_compute=flops / PEAK_FLOPS,
        t_memory=byts / HBM_BW,
        t_collective=coll["total"] / ICI_BW,
        model_flops=model_flops(cfg, shape_cfg),
        peak_memory_bytes=cost.get("peak"),
        bytes_hlo=byts,
    )
