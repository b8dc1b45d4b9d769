"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536
[arXiv:2403.19887]. Period of 8 layers: one attention layer per period
(ratio 1:7), MoE replacing the MLP on every other layer (4 of 8).
Mamba sublayers use the Jamba hyperparameters (d_state 16, conv 4,
expand 2). Hybrid ⇒ long_500k runs: the 4 attention layers use
sequence-sharded KV caches, every other layer is O(1)-state.
"""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    pattern=("m", "M", "m", "M", "a", "M", "m", "M"),
    mlp="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
)
