"""Plain PyTorch version of the scheduled block-sparse product kernel."""

from __future__ import annotations

import torch

from ...core.semiring import PLUS_TIMES, Semiring

__all__ = ["bsr_spgemm_ref"]


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
