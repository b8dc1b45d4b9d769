"""Model/architecture configuration schema.

One :class:`ModelConfig` per assigned architecture lives in
``configs/<arch>.py``; the registry (``configs/registry.py``) resolves
``--arch <id>`` and provides the reduced smoke-test variants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # always-on shared experts (qwen2-moe)
    d_ff_shared: int = 0
    every_k_layers: int = 1      # MoE replaces the MLP every k-th layer
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    @property
    def n_experts_padded(self) -> int:
        """Experts padded to a multiple of 16 for clean EP sharding."""
        return -(-self.n_experts // 16) * 16


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    # layer pattern: kinds per period, tiled to n_layers.
    #   'a' attention+MLP   'A' attention+MoE
    #   'm' mamba+MLP       'M' mamba+MoE
    #   'l' local(sliding)-attention+MLP  (gemma2 alternation: 'l','a')
    pattern: Tuple[str, ...] = ("a",)
    mlp: str = "swiglu"          # swiglu | geglu | relu2
    qk_norm: bool = False        # qwen3
    attn_softcap: float = 0.0    # gemma2: 50.0
    logit_softcap: float = 0.0   # gemma2: 30.0
    window: int = 0              # sliding window for 'l' layers (gemma2 4096)
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    input_kind: str = "tokens"   # tokens | embeds (vlm/audio frontend stub)
    norm_eps: float = 1e-6
    # training knobs
    remat: str = "block"         # none | block | full
    dtype: str = "bfloat16"      # compute dtype
    param_dtype: str = "float32"
    attn_chunk: int = 1024       # kv-chunk of the flash-style attention
    # dry-run cost-extraction knobs: XLA cost_analysis counts while-loop
    # bodies ONCE, so the cost lowerings unroll every scan (see dryrun.py)
    unroll_layers: bool = False
    unroll_inner: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            (self.name, self.n_layers, self.pattern)
        return self.n_layers // len(self.pattern)

    @property
    def has_attention(self) -> bool:
        return any(k in "aAl" for k in self.pattern)

    @property
    def full_attention(self) -> bool:
        """True if any layer is full (non-windowed, non-ssm) attention."""
        return any(k in "aA" for k in self.pattern)

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility: sub-quadratic sequence mixing dominates.

        SSM archs are O(1)-state; hybrids (jamba) amortize their few
        attention layers with sequence-sharded KV caches. Pure
        full-attention archs skip long_500k (recorded in the roofline
        table), per the assignment sheet.
        """
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND."""
        d, hd = self.d_model, self.hd
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        per = {}
        per_attn = d * n_q + 2 * d * n_kv + n_q * d
        gate = 2 if self.mlp in ("swiglu", "geglu") else 1
        per_mlp = (gate * d * self.d_ff) + self.d_ff * d
        moe = self.moe
        if moe is not None:
            per_moe = moe.n_experts * ((gate * d * moe.d_ff_expert)
                                       + moe.d_ff_expert * d) + d * moe.n_experts
            if moe.n_shared:
                per_moe += moe.n_shared * ((gate * d * moe.d_ff_shared)
                                           + moe.d_ff_shared * d)
        else:
            per_moe = 0
        if self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            per_ssm = d * (2 * di + 2 * s.d_state + nh) + di * d \
                + s.d_conv * (di + 2 * s.d_state) + 2 * nh
        else:
            per_ssm = 0
        total = self.vocab * d  # embed (tied)
        for k in self.pattern:
            blk = {"a": per_attn + per_mlp,
                   "l": per_attn + per_mlp,
                   "A": per_attn + per_moe,
                   "m": per_ssm + per_mlp,
                   "M": per_ssm + per_moe}[k]
            total += (blk + 2 * d) * self.n_periods
        if not self.tie_embeddings:
            total += self.vocab * d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        moe = self.moe
        gate = 2 if self.mlp in ("swiglu", "geglu") else 1
        per_expert = gate * d * moe.d_ff_expert + moe.d_ff_expert * d
        inactive = (moe.n_experts - moe.top_k) * per_expert
        n_moe_layers = sum(1 for k in self.pattern if k in "AM") \
            * self.n_periods
        return self.param_count() - inactive * n_moe_layers


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
