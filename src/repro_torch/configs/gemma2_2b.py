"""gemma2-2b [dense] — local/global alternating attention with softcaps.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 [arXiv:2408.00118].
Sliding window 4096 on local layers; attn softcap 50, final-logit softcap
30; GeGLU MLP; head_dim 256.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_ff=9216, vocab=256000, head_dim=256,
    pattern=("l", "a"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0, mlp="geglu",
)
