"""Model-facing attention op: ``multihead_attention`` (forward only).

Takes the model layout ``q (B, S, Hq, D)``, ``k, v (B, S, Hkv, D)`` and
hands it to the kernel wrapper, which dispatches on the device: a CUDA
tensor launches the hand-written kernel, a CPU tensor runs the plain
version. The reference's GQA fold, kv-head repeat and pad of S to 128 are
not done here: the kernel reads kv head ``h // rep`` in place and masks
keys past S, which for causal attention gives what the padded Pallas path
gives (a padded key is never at or before a real query). The backward pass
(``repro``'s custom VJP through ``chunked.py``) comes with the training
slice.
"""

from __future__ import annotations

from . import kernel

__all__ = ["multihead_attention"]


def multihead_attention(q, k, v, scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """(B, S, Hq, D) attention against (B, S, Hkv, D) keys and values;
    returns (B, S, Hq, D) in q's dtype."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{k.shape[2]} kv heads do not divide "
                         f"{q.shape[2]} query heads")
    return kernel.flash_attention(q, k, v, scale=scale, causal=causal,
                                  window=window, softcap=softcap)
