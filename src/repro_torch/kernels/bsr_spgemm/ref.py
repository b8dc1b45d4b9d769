"""Plain PyTorch version of the scheduled block-sparse product kernel, and
a CPU model of the tensor-core route's arithmetic (tests only)."""

from __future__ import annotations

import torch

from ...core.semiring import PLUS_TIMES, Semiring

__all__ = ["bsr_spgemm_ref", "tf32_split", "bsr_spgemm_tc_model"]

# depth of the tensor-core kernel's k-panels (csrc/bsr_spgemm_tc.cu: BK)
TC_PANEL = 32


def bsr_spgemm_ref(a_tiles, b_tiles, a_slot, b_slot, c_slot,
                   *, nc: int, semiring: Semiring = PLUS_TIMES,
                   seg_start: int = 0, seg_len: int = None):
    """Segment-reduce formulation of the same schedule.

    C[c_slot[s]] (+)= A[a_slot[s]] ⊗ B[b_slot[s]]  for every product s in
    ``[seg_start, seg_start + seg_len)``, over the additive monoid of
    ``semiring``: gather the tiles, one batched ``semiring.matmul``, one
    ``semiring.segment_reduce`` into an identity-filled ``(nc, bs, bs)``
    output. Slots no product visits hold ``semiring.zero``. It materializes
    every product at once (an O(nprod·bs²) intermediate) — it is the
    reference, not the product path. An empty window returns a
    ``(max(nc, 1), bs, bs)`` identity fill, like the kernel.
    """
    bs = a_tiles.shape[-1]
    if seg_len is None:
        seg_len = len(a_slot) - seg_start
    window = slice(seg_start, seg_start + seg_len)
    a_slot, b_slot, c_slot = a_slot[window], b_slot[window], c_slot[window]
    if len(a_slot) == 0:
        return torch.full((max(nc, 1), bs, bs), semiring.zero,
                          dtype=torch.float32, device=a_tiles.device)
    prods = semiring.matmul(a_tiles[a_slot.long()].float(),
                            b_tiles[b_slot.long()].float())
    return semiring.segment_reduce(prods, c_slot, nc)


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, low 13 bits cleared: ``cvt.rna.tf32.f32`` in bit
    operations. Adding half a TF32 ulp to the sign-magnitude bits rounds
    the magnitude and carries into the exponent; past FLT_MAX it gives
    infinity."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``(hi, lo)`` as the tensor-core route splits a float32 operand:
    ``hi = rna_tf32(x)``, ``lo = rna_tf32(x - hi)``. For every integer
    ``|x| < 2**22`` ``hi + lo == x`` exactly, and ``lo == 0`` for ``|x| <=
    2048``. A non-finite x keeps x in hi (a NaN as the quiet NaN) and 0 in
    lo. The split does not keep IEEE's non-finite rules (``inf * hi + inf *
    lo`` is NaN where hi and lo differ in sign, and an ``|x|`` near FLT_MAX
    rounds its hi to infinity), so the kernel never splits a panel that
    holds such an element (:func:`_wide`)."""
    x = x.float()
    finite = torch.isfinite(x)
    hi = torch.where(finite, _rna_tf32(x),
                     torch.where(torch.isnan(x), float("nan"), x))
    lo = torch.where(finite, _rna_tf32(torch.where(finite, x - hi, 0.0)),
                     0.0)
    return hi, lo


def _wide(t: torch.Tensor) -> bool:
    """Whether ``t`` holds an element the split cannot carry: infinity,
    NaN or ``|x| >= 2**127`` (an exponent of 0xFE or 0xFF)."""
    return bool((~(t.abs() < 2.0 ** 127)).any())


def bsr_spgemm_tc_model(a_tiles, b_tiles, a_slot, b_slot, c_slot, *,
                        nc: int, semiring: Semiring = PLUS_TIMES,
                        seg_start: int = 0, seg_len: int = None,
                        terms: int = 4):
    """The tensor-core route's arithmetic on the CPU, product by product
    and k-panel by k-panel (``TC_PANEL`` deep), in float32:

    * plus_times: both operands split by :func:`tf32_split`; a panel sums
      lo·lo unless its A lo or B lo is all zero, lo·hi unless its A lo is,
      hi·lo unless its B lo is, then hi·hi (``terms=3`` drops lo·lo
      everywhere, ``terms=1`` keeps hi·hi only); a panel whose A or B part
      holds an infinity, a NaN or an ``|x| >= 2**127`` is not split but
      multiplied as it is in float32 (the kernel's CUDA-core panel); a zero
      result is +0;
    * bool_or_and: both operands booleanized (``x != 0``), the hi·hi pass
      only, the run's sum clipped to 1 at its end.

    Each panel sums from zero; a run's panels add up in order, starting
    from its first; slots no product visits hold the identity. Each term's
    products are exact in float32, so integer-valued inputs whose sums
    stay below 2**24 match the plain version bitwise whatever the
    summation order."""
    bs = a_tiles.shape[-1]
    if seg_len is None:
        seg_len = len(a_slot) - seg_start
    window = range(seg_start, seg_start + seg_len)
    out = torch.full((max(nc, 1) if seg_len == 0 else nc, bs, bs),
                     semiring.zero, dtype=torch.float32)
    if semiring.name == "bool_or_and":
        def parts(t):
            return (t != 0).float(), torch.zeros_like(t, dtype=torch.float32)
    elif semiring.name == "plus_times":
        parts = tf32_split
    else:
        raise ValueError(f"the tensor-core route has no {semiring.name!r}")
    ends = {s for s in window if s + 1 == window.stop
            or int(c_slot[s + 1]) != int(c_slot[s])}
    acc = None
    for s in window:
        a, b = a_tiles[int(a_slot[s])].float(), b_tiles[int(b_slot[s])].float()
        ah, al = parts(a)
        bh, bl = parts(b)
        for k0 in range(0, bs, TC_PANEL):
            k = slice(k0, k0 + TC_PANEL)
            a_lo, b_lo = bool(al[:, k].any()), bool(bl[k].any())
            panel = torch.zeros(bs, bs, dtype=torch.float32)
            if semiring.name == "plus_times" and (_wide(a[:, k])
                                                  or _wide(b[k])):
                panel += a[:, k] @ b[k]
                acc = panel if acc is None else acc + panel
                continue
            if a_lo and b_lo and terms >= 4:
                panel += al[:, k] @ bl[k]
            if a_lo and terms >= 3:
                panel += al[:, k] @ bh[k]
            if b_lo and terms >= 3:
                panel += ah[:, k] @ bl[k]
            panel += ah[:, k] @ bh[k]
            acc = panel if acc is None else acc + panel
        if s in ends:
            c = int(c_slot[s])
            out[c] = (acc.clamp(max=1.0) if semiring.name == "bool_or_and"
                      else acc + 0.0)
            acc = None
    return out
