"""Architecture registry: ``--arch <id>`` lookup + reduced smoke variants."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from .base import SHAPES, ModelConfig, MoEConfig, SSMConfig

__all__ = ["ARCHS", "get_config", "smoke_config", "list_archs", "SHAPES"]

ARCHS: Dict[str, str] = {
    "musicgen-large": "musicgen_large",
    "pixtral-12b": "pixtral_12b",
    "mamba2-1.3b": "mamba2_1_3b",
    "gemma2-2b": "gemma2_2b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen3-8b": "qwen3_8b",
    "nemotron-4-15b": "nemotron_4_15b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "qwen2-moe-a2.7b": "qwen2_moe",
    "jamba-v0.1-52b": "jamba_v01_52b",
}


def list_archs() -> List[str]:
    return list(ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCHS)}")
    mod = importlib.import_module(f".{ARCHS[arch]}", __package__)
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Same family/pattern/features, laptop-scale dims for CPU smoke tests."""
    cfg = get_config(arch)
    kv_ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_heads = 4
    n_kv = max(1, n_heads // min(kv_ratio, n_heads))
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            n_experts=min(8, cfg.moe.n_experts), top_k=min(2, cfg.moe.top_k),
            d_ff_expert=32,
            n_shared=min(1, cfg.moe.n_shared),
            d_ff_shared=32 if cfg.moe.n_shared else 0,
            every_k_layers=cfg.moe.every_k_layers)
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=8, chunk=8)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2 * len(cfg.pattern),
        d_model=64, n_heads=n_heads, n_kv_heads=n_kv, head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=128, window=8 if cfg.window else 0,
        moe=moe, ssm=ssm, dtype="float32", remat="none",
    )
