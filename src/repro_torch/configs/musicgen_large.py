"""musicgen-large [audio] — decoder-only LM over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]. The EnCodec audio frontend is a stub: the model
consumes precomputed codebook token ids (vocab 2048) directly.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, head_dim=64,
    pattern=("a",), mlp="swiglu", input_kind="tokens",
)
