"""The language-model stack: training (loss and gradients) and serving
(prefill and decode).

layers.py      norms, RoPE, MLP variants (swiglu/geglu/relu2), init helpers
attention.py   GQA + qk-norm + softcap + sliding window; train and prefill
               (the flash_attention kernel) and decode (plain torch)
mamba2.py      SSD chunked scan, the state after a prefill, O(1) decode
               recurrence (plain torch, as the reference's plain jnp)
moe.py         SpGEMM-framed expert dispatch, expert FFNs on moe_gemm
blocks.py      pattern kinds 'a' attn+MLP, 'A' attn+MoE, 'l' local-attn+MLP,
               'm' mamba+MLP (or mamba alone at d_ff 0), 'M' mamba+MoE
transformer.py the layer stack: init_params / loss_fn / train_logits /
               prefill_step / decode_step
convert.py     the reference's parameter tree and train state in the port's
               layout
"""

from .convert import params_from_reference, train_state_from_reference
from .mamba2 import (SSMState, init_ssm_state, mamba_decode, mamba_init,
                     mamba_prefill, mamba_train)
from .transformer import (decode_step, init_caches, init_params, loss_fn,
                          prefill_step, train_logits)
