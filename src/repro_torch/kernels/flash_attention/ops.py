"""Model-facing attention op: ``multihead_attention``, differentiable.

Takes the model layout ``q (B, S, Hq, D)``, ``k, v (B, S, Hkv, D)``.

Forward: the kernel wrapper, which dispatches on the device: a CUDA tensor
launches the hand-written kernel of its route (bf16 on the tensor cores,
float32 on them too, in split TF32 at float32 accuracy), a CPU tensor runs
the plain version. The reference's GQA fold, kv-head repeat and pad of S to
128 are not done here: the kernels read kv head ``h // rep`` in place and
mask keys past S, which for causal attention gives what the padded Pallas
path gives (a padded key is never at or before a real query).

Backward: the reference's custom VJP (``_mha_bwd``): kv heads repeated up to
the query heads (``repeat_interleave``, the reference's ``jnp.repeat``), the
plain chunked recurrence (``chunked.attention_chunked``, chunk 1024)
recomputed under autograd, and its gradient. The backward is plain torch,
as it is plain ``jnp`` in the reference; the forward kernel is launched once
per forward (and once more per recompute under the model's block remat).
The inputs are saved as they are: callers hand contiguous q, k and v, which
the kernel requires (``kernel.check_launch_args``).
"""

from __future__ import annotations

import torch

from . import kernel
from .chunked import attention_chunked

__all__ = ["multihead_attention"]


class _Attention(torch.autograd.Function):
    """Kernel forward, plain chunked-recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, causal, window, softcap)
        return kernel.flash_attention(q, k, v, scale=scale, causal=causal,
                                      window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale, causal, window, softcap = ctx.args
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            rep = q.shape[2] // k.shape[2]
            kr, vr = k, v
            if rep > 1:
                kr = k.repeat_interleave(rep, dim=2)
                vr = v.repeat_interleave(rep, dim=2)
            out = attention_chunked(q, kr, vr, scale=scale, causal=causal,
                                    window=window, softcap=softcap)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def multihead_attention(q, k, v, scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """(B, S, Hq, D) attention against (B, S, Hkv, D) keys and values;
    returns (B, S, Hq, D) in q's dtype. Differentiable in q, k and v."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{k.shape[2]} kv heads do not divide "
                         f"{q.shape[2]} query heads")
    return _Attention.apply(q, k, v, scale, causal, window, softcap)
