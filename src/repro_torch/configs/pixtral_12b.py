"""pixtral-12b [vlm] — mistral-nemo decoder over pixtral-ViT patch embeds.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]. The ViT frontend is a stub:
``input_specs()`` supplies precomputed patch embeddings (B, S, d_model);
labels/logits remain over the text vocab (tied embedding).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=160,
    pattern=("a",), mlp="swiglu", input_kind="embeds",
    rope_theta=1e6,
)
