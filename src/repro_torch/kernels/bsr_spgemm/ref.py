"""Plain PyTorch version of the scheduled block-sparse product kernel, and
CPU models of the tensor-core routes' arithmetic and of the min-plus
route's split into worker shares (tests only)."""

from __future__ import annotations

import numpy as np
import torch

from ...core.semiring import MIN_PLUS, PLUS_TIMES, Semiring

__all__ = ["bsr_spgemm_ref", "tf32_split", "split_terms", "unsplit_where",
           "bsr_spgemm_tc_model", "bsr_spgemm_minplus_model"]

# depth of the k-panels of the bs-64/128 kernels (csrc/bsr_spgemm_tc.cu,
# bsr_spgemm_minplus.cu: BK)
PANEL = 32


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
    rounds its hi to infinity), so the kernels never split a panel that
    holds such an element, nor one where hi·hi could overflow
    (:func:`unsplit_where`)."""
    x = x.float()
    finite = torch.isfinite(x)
    hi = torch.where(finite, _rna_tf32(x),
                     torch.where(torch.isnan(x), float("nan"), x))
    lo = torch.where(finite, _rna_tf32(torch.where(finite, x - hi, 0.0)),
                     0.0)
    return hi, lo


# the least |p| that float32 rounds to infinity: FLT_MAX plus half its ulp
_TO_INF = 2.0 ** 128 - 2.0 ** 103


def split_terms(pairs) -> torch.Tensor:
    """``sum(a @ b for a, b in pairs)`` for float32 TF32 parts (a (..., M,
    K), b (..., K, N)) as the split-TF32 routes form it: each product is
    exact in float32 (11 by 11 significant bits) unless it passes FLT_MAX,
    where it is an infinity, as the tensor core's fp32 product; the products
    are summed in float64 and rounded to float32 once. Rows that hold no
    product that large take float64 matmuls; if any does, every product is
    formed in float32 one by one."""
    out = sum(a.double() @ b.double() for a, b in pairs)
    if any(bool((a.double().abs().amax(-1, keepdim=True)
                 * b.double().abs().amax(-2, keepdim=True)
                 >= _TO_INF).any()) for a, b in pairs):
        out = sum((a.unsqueeze(-1) * b.unsqueeze(-3)).double().sum(-2)
                  for a, b in pairs)
    return out.float()


def unsplit_where(a_mag: torch.Tensor, b_mag: torch.Tensor) -> torch.Tensor:
    """Where the kernels sum a k-panel unsplit, from the largest magnitude
    of its A part and of its B part (float32 tensors that broadcast; a NaN
    anywhere in a part makes its magnitude NaN, as ``amax`` gives it)
    (``kernels/hopper.cuh::unsplit_panel``): either part holds an infinity,
    a NaN or an ``|x| >= 2**127`` (an exponent of 0xFE or 0xFF, which the
    split cannot carry), or the float32 product of the two magnitudes is
    NaN or at least ``2**126``. A TF32 hi is at most ``|x| (1 + 2**-11)``,
    so below that bound every ``hi_a hi_b`` stays under ``2**127``; at or
    above it hi·hi could overflow where the float32 product does not."""
    wide = lambda m: ~(m < 2.0 ** 127)                      # noqa: E731
    return wide(a_mag) | wide(b_mag) | ~(a_mag * b_mag < 2.0 ** 126)


def _unsplit(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the kernels sum the k-panel ``a @ b`` unsplit
    (:func:`unsplit_where` of the two parts' largest magnitudes)."""
    return bool(unsplit_where(a.abs().max(), b.abs().max()))


def bsr_spgemm_tc_model(a_tiles, b_tiles, a_slot, b_slot, c_slot, *,
                        nc: int, semiring: Semiring = PLUS_TIMES,
                        seg_start: int = 0, seg_len: int = None,
                        terms: int = 4):
    """The tensor-core route's arithmetic on the CPU, product by product
    and k-panel by k-panel (``PANEL`` deep), in float32:

    * plus_times: both operands split by :func:`tf32_split`; a panel sums
      lo·lo unless its A lo or B lo is all zero, lo·hi unless its A lo is,
      hi·lo unless its B lo is, then hi·hi (``terms=3`` drops lo·lo
      everywhere, ``terms=1`` keeps hi·hi only); a panel whose A or B part
      holds an infinity, a NaN or an ``|x| >= 2**127``, or whose parts'
      largest magnitudes multiply to ``2**126`` or more (:func:`_unsplit`),
      is not split but multiplied as it is in float32 (the kernel's
      CUDA-core panel); a zero result is +0;
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
        for k0 in range(0, bs, PANEL):
            k = slice(k0, k0 + PANEL)
            a_lo, b_lo = bool(al[:, k].any()), bool(bl[k].any())
            panel = torch.zeros(bs, bs, dtype=torch.float32)
            if semiring.name == "plus_times" and _unsplit(a[:, k], b[k]):
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


def bsr_spgemm_minplus_model(a_tiles, b_tiles, a_slot, b_slot, c_slot,
                             run_starts, *, nc: int, workers: int):
    """The ``"minplus"`` route's split of a window, on the CPU, with the
    plain version doing the arithmetic: the window's real products
    (``run_starts[0]`` to ``run_starts[-1]``) as 32-deep k-panels, shared
    among ``workers`` as the kernel shares them (``kernel.minplus_shares``);
    each share's piece of a run reduced by :func:`bsr_spgemm_ref` over
    k-sliced tiles, the piece holding a run's first panel written to the
    output, every later piece (a share's head) kept apart; then each head
    min-combined into its run's output (the combine pass). Slots no run
    writes hold +inf. Min-plus is exact in any order, so this equals
    :func:`bsr_spgemm_ref` over the window bitwise, a NaN as any NaN."""
    from .kernel import minplus_shares

    bs = a_tiles.shape[-1]
    kp = bs // PANEL
    # panel k of tile t is row t * kp + k of these stacks
    a_pan = a_tiles.float().reshape(-1, bs, kp, PANEL).transpose(1, 2) \
        .reshape(-1, bs, PANEL)
    b_pan = b_tiles.float().reshape(-1, kp, PANEL, bs).reshape(-1, PANEL, bs)
    rs = np.asarray(run_starts, dtype=np.int64)
    a_slot, b_slot, c_slot = (np.asarray(t, dtype=np.int64)
                              for t in (a_slot, b_slot, c_slot))
    bounds, heads = minplus_shares(rs, workers, bs)
    u = np.arange(bounds[-1])
    prod = rs[0] + u // kp
    pa = torch.from_numpy(a_slot[prod] * kp + u % kp)
    pb = torch.from_numpy(b_slot[prod] * kp + u % kp)
    run = np.searchsorted(rs[:-1], prod, side="right") - 1
    slot = torch.from_numpy(c_slot[rs[:-1]][run])
    out = torch.full((nc, bs, bs), float("inf"))
    pieces = []
    for w in range(workers):
        share = np.arange(bounds[w], bounds[w + 1])
        head = run[share] == heads[w]
        for sel, into in ((share[~head], None), (share[head], w)):
            if len(sel) == 0:
                continue
            part = bsr_spgemm_ref(a_pan, b_pan, pa[sel], pb[sel], slot[sel],
                                  nc=nc, semiring=MIN_PLUS)
            visited = torch.unique(slot[sel])
            if into is None:
                out[visited] = part[visited]
            else:
                pieces.append((int(visited[0]), part[visited[0]]))
    for c, piece in pieces:
        out[c] = torch.minimum(out[c], piece)
    return out
