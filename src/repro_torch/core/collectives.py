"""Moving tile payloads between ranks over ``torch.distributed``.

The port's counterpart of the collectives the reference's device engines
run under ``shard_map``: the ring's ``ppermute`` (one point-to-point
step), SUMMA's ``all_gather`` over one mesh axis, and the reduction over
Split-3D's layer axis. Here they run between processes, one part per rank.

:class:`Transport` does three things over one process group:

  * a ring step (:meth:`Transport.ring_start`): ``batch_isend_irecv`` to
    ``(j - s) % P`` and from ``(j + s) % P``, the reference's canonical
    rotation ``[(j, (j - s) % P)]``;
  * a gather over one mesh dim (:meth:`Transport.gather_start`): every
    member's block, in the dim's order, by point-to-point exchange between
    the dim's members;
  * a count of the bytes it sends and receives, per kind (``"ring"``,
    ``"gather"``, ``"merge"``, ``"result"``), for the tests and the smoke
    run. The count is not a stats key of the session.

Every payload goes over the caller's process group and its backend, never
another: a finite timeout on that group bounds every wait here, and a
failed operation raises. The layer merge is a gather followed by a
reduction in layer order on each rank (``spgemm_2d_device``), not an
``all_reduce(MIN/MAX)``: gloo's MIN and MAX drop a NaN that does not sit on
rank 0, and min-plus keeps NaN.

NCCL moves device tensors in place. gloo moves host tensors, so on a card
the gloo transport copies each payload into pinned host memory before it
sends, and the received bytes back to the device after the wait — in plain
sight in :meth:`Transport._wire`, :meth:`Transport._landing` and
:class:`Pending` — a piece of at most ``PIECE_BYTES`` at a time.

Besides the transport, three small collectives over the group keep the
ranks in step: :func:`agree` (did any rank fail a stage?),
:func:`all_same` (do the ranks hold the same fingerprints?) and
:func:`gather_rows` / :func:`gather_csc` (every rank's decoded output
piece, on every rank).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .sparse import CSC, from_coo

__all__ = ["Transport", "Pending", "wire_device", "agree", "all_same",
           "gather_rows", "gather_csc", "mesh_index", "dim_ranks"]

# transfer kinds the transport counts bytes for
KINDS = ("ring", "gather", "merge", "result")
# the largest piece a transfer moves at once outside NCCL (Transport)
PIECE_BYTES = 64 << 20


def wire_device(group=None) -> torch.device:
    """Where a tensor must lie to cross ``group``: the current CUDA device
    for NCCL, the host for every other backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_index(mesh) -> Optional[int]:
    """This rank's flat position in ``mesh`` (C order over its dims), or
    None when the rank is not a member."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    return int(np.ravel_multi_index(tuple(coord), tuple(mesh.mesh.shape)))


def dim_ranks(mesh, dim: str) -> List[int]:
    """The global ranks of this rank's line along mesh dim ``dim``, in that
    dim's order (this rank among them)."""
    coord = list(mesh.get_coordinate())
    d = mesh.mesh_dim_names.index(dim)
    idx = tuple(slice(None) if i == d else c for i, c in enumerate(coord))
    return [int(r) for r in mesh.mesh[idx].reshape(-1).tolist()]


class Pending:
    """Transfers in flight, moved in rounds of pieces (one round when the
    transfer is whole). The first round is posted when the transfer
    starts; :meth:`wait` completes it, posts the rest one after another,
    and returns the received tensors on the transport's device."""

    def __init__(self, transport: "Transport", sends, recvs):
        t = self._t = transport
        self._sends, self._recvs = sends, recvs
        self._out = [torch.empty(shape, dtype=dtype, device=t.device)
                     for _, shape, dtype, _ in recvs]
        self._rows = [t._piece_rows(x.shape, x.dtype) for _, x, _ in sends]
        self._rows_in = [t._piece_rows(o.shape, o.dtype) for o in self._out]
        counts = [-(-x.shape[0] // r) for (_, x, _), r in
                  zip(sends, self._rows)] + \
            [-(-o.shape[0] // r) for o, r in zip(self._out, self._rows_in)]
        self._rounds = max(counts, default=0)
        self._k = 0
        self._inflight = self._post(0) if self._rounds else None

    def _post(self, k: int):
        """Post round ``k``: every send's and receive's k-th piece that
        exists, in one batch."""
        t, ops, sent, landing = self._t, [], [], []
        for (peer, x, tag), r in zip(self._sends, self._rows):
            if k * r < x.shape[0]:
                buf = t._wire(x[k * r:(k + 1) * r])
                sent.append(buf)
                ops.append(dist.P2POp(dist.isend, buf, peer, t.group, tag))
        for (peer, _, _, tag), out, r in zip(self._recvs, self._out,
                                             self._rows_in):
            if k * r < out.shape[0]:
                dst = out[k * r:(k + 1) * r]
                buf = t._landing(dst)
                landing.append((dst, buf))
                ops.append(dist.P2POp(dist.irecv, buf, peer, t.group, tag))
        return (dist.batch_isend_irecv(ops) if ops else []), landing, sent

    def wait(self) -> List[torch.Tensor]:
        while self._inflight is not None:
            works, landing, _ = self._inflight
            for w in works:
                w.wait()
            for dst, buf in landing:
                if buf is not dst:
                    dst.copy_(buf)
            self._k += 1
            self._inflight = (self._post(self._k)
                              if self._k < self._rounds else None)
        return self._out


class Transport:
    """Point-to-point transfers of tile stacks over one process group.

    ``device`` is where the payloads live and land (the rank's card, or
    the host). ``sent[kind]`` / ``received[kind]`` count the payload bytes
    this rank handed to and took from the group, per kind.

    Over any backend but NCCL a transfer larger than ``PIECE_BYTES``
    (``piece_bytes``) moves in pieces of at most that size, one round
    after another, so a rank stages at most one piece of each transfer in
    host memory however large the transfer: ranks sharing one host that
    each staged whole gathers and layer partials (a Split-3D partial of
    laplacian_2d(1024)² at bs 128 is 3.2 GB) would hold tens of GB of
    pinned memory between them. The Split-3D merge cuts its partials into
    pieces of the same size on every backend (``spgemm_2d_device``), which
    bounds the device memory it adds.
    """

    def __init__(self, device, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.device = torch.device(device)
        self.backend = dist.get_backend(self.group)
        # gloo moves host tensors: a card's payloads are staged through
        # pinned host buffers, a piece at a time
        self.staged = self.backend != "nccl" and self.device.type == "cuda"
        self.piece_bytes = PIECE_BYTES
        self.rank = dist.get_rank()
        self.sent: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.received: Dict[str, int] = dict.fromkeys(KINDS, 0)

    def reset_counts(self) -> None:
        for k in KINDS:
            self.sent[k] = self.received[k] = 0

    def _piece_rows(self, shape, dtype) -> int:
        """Leading-dim rows per piece of a tensor of ``shape``: all of them
        over NCCL, else as many as fit in ``piece_bytes`` (at least one)."""
        n = max(int(shape[0]), 1)
        if self.backend == "nccl":
            return n
        row = int(np.prod(shape[1:], dtype=np.int64)) * \
            torch.empty((), dtype=dtype).element_size()
        return max(1, min(n, self.piece_bytes // max(row, 1)))

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """The buffer that crosses the group: ``x`` itself, or a pinned
        host copy of it where gloo carries a card's payload."""
        if not self.staged:
            return x.contiguous()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf

    def _landing(self, dst: torch.Tensor) -> torch.Tensor:
        """Where a received piece lands: in place in ``dst``, or in a
        pinned host buffer copied to ``dst`` after the wait."""
        if not self.staged:
            return dst
        return torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True)

    def _exchange(self, kind: str, sends, recvs) -> Pending:
        """Start every send and receive of one transfer. ``sends`` are
        ``(peer, tensor, tag)``, ``recvs`` ``(peer, shape, dtype, tag)``,
        listed in the same order on every rank (NCCL pairs a batch's
        operations in order); the received tensors come back from
        :meth:`Pending.wait` in ``recvs`` order."""
        for _, x, _ in sends:
            self.sent[kind] += x.numel() * x.element_size()
        for _, shape, dtype, _ in recvs:
            self.received[kind] += int(np.prod(shape, dtype=np.int64)) * \
                torch.empty((), dtype=dtype).element_size()
        return Pending(self, sends, recvs)

    def ring_start(self, payloads: Sequence[torch.Tensor],
                   shifts: Sequence[int], ranks: Sequence[int]) -> Pending:
        """Ring steps ``shifts`` at once: at shift s, member j of ``ranks``
        sends ``payloads[i]`` to member (j - s) % P and receives the same
        shape from member (j + s) % P. The received stacks come back from
        :meth:`Pending.wait` in ``shifts`` order."""
        P = len(ranks)
        j = ranks.index(self.rank)
        return self._exchange(
            "ring",
            [(ranks[(j - s) % P], x, s) for x, s in zip(payloads, shifts)],
            [(ranks[(j + s) % P], tuple(x.shape), x.dtype, s)
             for x, s in zip(payloads, shifts)])

    def gather_start(self, x: torch.Tensor, ranks: Sequence[int],
                     kind: str = "gather", tag: int = 0) -> "Gathered":
        """Every member's ``x`` (same shape and dtype on each) along one
        mesh line ``ranks``; :meth:`Gathered.wait` returns them stacked in
        ``ranks`` order, this rank's own block in its place."""
        peers = [r for r in ranks if r != self.rank]
        pend = self._exchange(
            kind, [(r, x, tag) for r in peers],
            [(r, tuple(x.shape), x.dtype, tag) for r in peers])
        return Gathered(pend, x, list(ranks), self.rank)


class Gathered:
    """A gather in flight (:meth:`Transport.gather_start`)."""

    def __init__(self, pending: Pending, own: torch.Tensor,
                 ranks: List[int], rank: int):
        self._pending = pending
        self._own = own
        self._ranks = ranks
        self._rank = rank

    def wait(self) -> torch.Tensor:
        got = iter(self._pending.wait())
        return torch.stack([self._own if r == self._rank else next(got)
                            for r in self._ranks])


# ---------------------------------------------------------------------------
# keeping the ranks in step
# ---------------------------------------------------------------------------

def agree(code: int, group=None) -> tuple:
    """All-reduce one rank's status ``code`` (0 = fine, larger = worse):
    returns ``(worst code, the highest rank that reported it)`` on every
    rank. Integer MAX, so no float NaN rule is involved."""
    rank = dist.get_rank(group)
    # the worst code in the high bits, then the highest rank reporting it
    key = torch.tensor([code * (1 << 20) + (rank + 1 if code else 0)],
                       dtype=torch.int64, device=wire_device(group))
    dist.all_reduce(key, op=dist.ReduceOp.MAX, group=group)
    worst, who = divmod(int(key.item()), 1 << 20)
    return worst, who - 1


def all_same(values: np.ndarray, group=None) -> bool:
    """Do all ranks hold the same int64 vector ``values``? (Element-wise
    MIN and MAX over the group, compared.)"""
    dev = wire_device(group)
    lo = torch.tensor(np.array(values, dtype=np.int64), device=dev)
    hi = lo.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    return bool(torch.equal(lo, hi))


def gather_rows(rows: Optional[np.ndarray], width: int, group=None,
                transport: Optional[Transport] = None
                ) -> Optional[List[np.ndarray]]:
    """Every rank's ``(n_i, width)`` int64 block, on every rank, in rank
    order. A rank that failed passes ``rows=None``; then every rank gets
    None back (the sizes exchange carries the failure), so no rank waits
    for a block that never comes. The blocks are padded to the largest
    and gathered with one ``all_gather``; ``transport`` (if given) counts
    the bytes under ``"result"``."""
    dev = wire_device(group)
    world = dist.get_world_size(group)
    n = -1 if rows is None else int(rows.shape[0])
    sizes = [torch.zeros(1, dtype=torch.int64, device=dev)
             for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([n], dtype=torch.int64, device=dev),
                    group=group)
    sizes = [int(s.item()) for s in sizes]
    if min(sizes) < 0:
        return None
    top = max(max(sizes), 1)
    mine = torch.zeros((top, width), dtype=torch.int64, device=dev)
    if n:
        mine[:n] = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    out = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(out, mine, group=group)
    if transport is not None:
        nb = mine.numel() * mine.element_size()
        transport.sent["result"] += nb
        transport.received["result"] += nb * (world - 1)
    return [o[:k].cpu().numpy() for o, k in zip(out, sizes)]


def gather_csc(coo: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]],
               shape: Tuple[int, int], group=None,
               transport: Optional[Transport] = None,
               failed: bool = False) -> Optional[CSC]:
    """Assemble the global CSC on every rank from each rank's COO triples
    ``(rows, cols, vals)`` (``None``: this rank holds no piece). Values
    travel as their float32 bits, so NaN payloads and signed zeros arrive
    as they left. Returns None on every rank when any rank passed
    ``failed=True`` (the caller raises)."""
    rows = None
    if not failed:
        if coo is None:
            rows = np.zeros((0, 3), dtype=np.int64)
        else:
            r, c, v = coo
            rows = np.stack([np.asarray(r, dtype=np.int64),
                             np.asarray(c, dtype=np.int64),
                             np.asarray(v, dtype=np.float32)
                             .view(np.int32).astype(np.int64)], axis=1)
    pieces = gather_rows(rows, 3, group, transport)
    if pieces is None:
        return None
    allr = np.concatenate(pieces, axis=0)
    vals = allr[:, 2].astype(np.int32).view(np.float32)
    return from_coo(allr[:, 0], allr[:, 1], vals, shape)
