"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct]. Every layer's FFN is MoE
(d_ff_expert = 6400); the paper's 1D SpGEMM technique drives the
expert-parallel dispatch (DESIGN.md §3).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064, head_dim=128,
    pattern=("A",), mlp="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
)
