"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B]. Highest routing sparsity in the pool
(4/60 active); experts are padded 60 → 64 for clean EP-16 sharding
(padded experts are masked to -inf in the router).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128,
    pattern=("A",), mlp="swiglu",
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared=4, d_ff_shared=1408),
)
