"""The language-model stack, serving path (prefill and decode).

layers.py      norms, RoPE, MLP variants (swiglu/geglu/relu2), init helpers
attention.py   GQA + qk-norm + softcap + sliding window; prefill (the
               flash_attention kernel) and decode (plain torch)
moe.py         SpGEMM-framed expert dispatch, expert FFNs on moe_gemm
blocks.py      pattern kinds 'a' attn+MLP, 'A' attn+MoE, 'l' local-attn+MLP
transformer.py the layer stack: init_params / prefill_step / decode_step
convert.py     the reference's parameter tree in the port's layout
"""

from .convert import params_from_reference
from .transformer import decode_step, init_caches, init_params, prefill_step
