"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality).

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060].
Faithful Mamba2 stacks pure mamba blocks with no separate MLP sublayer:
d_ff=0 makes the block's FFN an identity (see blocks.py). Attention-free
⇒ the paper's SpGEMM technique is N/A (no sparse-sparse product); runs
long_500k via the O(1)-state decode recurrence.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    pattern=("m",), mlp="swiglu",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)
