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

The language model's collectives over a ``DeviceMesh``'s dims are
:class:`MeshComm`'s (one per mesh, :func:`mesh_comm`): an all-to-all over
the ranks of one or more dims, an all-gather, and a reduce (sum or max),
all built on the transport's point-to-point exchange, so gloo stages every
payload through pinned host memory a piece at a time here too and every
wait is bounded by the group's timeout. A reduce is a reduce-scatter (each
rank sums or maxes its chunk from every rank, in rank order) and an
all-gather of the reduced chunks: every rank gets the same bits, and a NaN
on any rank survives a max. Their autograd forms, for the paths a gradient
crosses ranks on: :func:`all_to_all` (backward: the reverse all-to-all),
:func:`all_gather_cat` (backward: a reduce-scatter), :func:`reduce_scatter`
(backward: an all-gather), :func:`fsdp_gather` (parameter slices cast and
gathered, each along its FSDP dim, in one transfer; backward: one float32
reduce-scatter) and :func:`psum` (backward: the identity — the sum feeds an
objective every rank holds whole, and each rank carries the gradient back
to its own term). :func:`all_to_all` and :func:`dispatch_exchange` (the
MoE dispatch's live-row counts) are dispatcher ops (:data:`ALL_TO_ALL`,
:data:`EXCHANGE`), so that remat ``"dots"`` (``models.transformer``) can
save the MoE dispatch's results and its recompute sends nothing, as the
reference saves ``moe_a2a_fwd`` / ``moe_a2a_ret``; the comm travels to
them as its ``key`` (a ``MeshComm`` is not a schema type). Tensor
parallelism adds Megatron's input operator :func:`tp_copy` (the identity;
backward a sum), :func:`tp_gather` (an all-gather for a consumer every
rank runs whole; backward this rank's block) and :func:`tp_split` (this
rank's block; backward an all-gather).
"""

from __future__ import annotations

import itertools
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .sparse import CSC, from_coo

__all__ = ["Transport", "Pending", "wire_device", "agree", "all_same",
           "gather_rows", "gather_csc", "mesh_index", "dim_ranks",
           "MeshComm", "mesh_comm", "all_to_all", "dispatch_exchange",
           "ALL_TO_ALL", "EXCHANGE",
           "all_gather_cat", "reduce_scatter", "fsdp_gather", "psum",
           "tp_copy", "tp_gather", "tp_split"]

# transfer kinds the transport counts bytes for: the SpGEMM engines' four,
# then the language model's — "a2a" the MoE's bucket exchange (there and
# back), "rows" the live-row counts sent along with it, "vocab" the
# vocab-sharded embedding's, cross entropy's and logits' traffic, "fsdp"
# the FSDP gathers of parameter slices and their gradients'
# reduce-scatters, "tp" tensor parallelism's (the Megatron pairs' sums,
# head and expert gathers), "sp" the sequence-split KV caches' (the
# prefill's heads-to-sequence all-to-all, the decode step's gathers and its
# log-sum-exp combine), "reduce" every other reduce and gather (gradients,
# the aux loss, metrics, norms)
KINDS = ("ring", "gather", "merge", "result", "a2a", "rows", "vocab",
         "fsdp", "tp", "sp", "reduce")
# the largest piece a transfer moves at once outside NCCL (Transport)
PIECE_BYTES = 64 << 20
# MeshComm.reduce gathers tensors of at most this many elements whole (one
# round) rather than reduce-scattering them (two rounds)
SMALL_REDUCE = 4096


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


def dim_ranks(mesh, dim) -> List[int]:
    """The global ranks of this rank's line along mesh dim ``dim`` (or its
    sub-mesh over a sequence of dims, the other dims at this rank's
    coordinate), in C order over the mesh's dims: the order a tensor dim
    split over several axes is laid out in (this rank among them)."""
    dims = (dim,) if isinstance(dim, str) else tuple(dim)
    coord = list(mesh.get_coordinate())
    idx = tuple(slice(None) if n in dims else c
                for n, c in zip(mesh.mesh_dim_names, coord))
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

    def _count(self, kind: str, sends, recvs) -> None:
        """Add one transfer's payload bytes to ``sent`` / ``received``."""
        for _, x, _ in sends:
            self.sent[kind] += x.numel() * x.element_size()
        for _, shape, dtype, _ in recvs:
            self.received[kind] += int(np.prod(shape, dtype=np.int64)) * \
                dtype.itemsize

    def _exchange(self, kind: str, sends, recvs) -> Pending:
        """Start every send and receive of one transfer. ``sends`` are
        ``(peer, tensor, tag)``, ``recvs`` ``(peer, shape, dtype, tag)``,
        listed in the same order on every rank (NCCL pairs a batch's
        operations in order); the received tensors come back from
        :meth:`Pending.wait` in ``recvs`` order."""
        self._count(kind, sends, recvs)
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


# ---------------------------------------------------------------------------
# the language model's collectives over a mesh's dims
# ---------------------------------------------------------------------------

class MeshComm:
    """All-to-all, all-gather and reduce over the ranks of a
    ``DeviceMesh``'s dims, for tensors on this rank's device.

    ``sent`` / ``received`` count payload bytes per kind (:data:`KINDS`)
    over every device's transport; ``seconds`` the host wall time spent in
    each kind's collectives (the staging copies included), and ``calls``
    their number. Every member of a collective must call it, with blocks
    of the shapes its peers send: what a rank sends to a peer has the shape
    of what it receives from that peer. ``key`` names the comm to the
    dispatcher ops while it lives."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.key = next(_KEYS)
        _COMMS[self.key] = self
        self.sent: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.received: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.seconds: Dict[str, float] = dict.fromkeys(KINDS, 0.0)
        self.calls: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self._transports: Dict[torch.device, Transport] = {}
        self._ranks: Dict[Tuple[str, ...], List[int]] = {}

    def reset_counts(self) -> None:
        for k in KINDS:
            self.sent[k] = self.received[k] = self.calls[k] = 0
            self.seconds[k] = 0.0

    def ranks(self, dims: Sequence[str]) -> List[int]:
        key = tuple(dims)
        if key not in self._ranks:
            self._ranks[key] = dim_ranks(self.mesh, key)
        return self._ranks[key]

    def size(self, dims: Sequence[str]) -> int:
        return len(self.ranks(dims))

    @property
    def rank(self) -> int:
        """This process's global rank."""
        return dist.get_rank()

    def index(self, dims: Sequence[str]) -> int:
        """This rank's position among :meth:`ranks` ``(dims)``."""
        return self.ranks(dims).index(self.rank)

    def _transport(self, device: torch.device) -> Transport:
        if device not in self._transports:
            t = Transport(device)
            t.sent, t.received = self.sent, self.received
            self._transports[device] = t
        return self._transports[device]

    def _timed(self, kind: str, fn):
        t0 = time.perf_counter()
        out = fn()
        self.seconds[kind] += time.perf_counter() - t0
        self.calls[kind] += 1
        return out

    def exchange(self, blocks: Sequence[torch.Tensor], dims: Sequence[str],
                 kind: str, shapes: Optional[Sequence[tuple]] = None
                 ) -> List[torch.Tensor]:
        """All-to-all: ``blocks[i]`` goes to member i of :meth:`ranks`
        ``(dims)``; returns the block each member sent this rank, in member
        order (this rank's own block as it is). ``shapes[i]``: the shape of
        the block member i sends this rank (by default ``blocks[i]``'s);
        a block with no element does not travel."""
        ranks = self.ranks(dims)
        me = ranks.index(self.rank)
        if len(ranks) == 1:
            return [blocks[0]]
        t = self._transport(blocks[0].device)
        dtype = blocks[0].dtype
        shapes = [tuple(b.shape) for b in blocks] if shapes is None \
            else [tuple(s) for s in shapes]

        def run():
            blk = [b.contiguous() for b in blocks]
            pend = t._exchange(
                kind,
                [(r, blk[i], 0) for i, r in enumerate(ranks)
                 if i != me and blk[i].numel()],
                [(r, shapes[i], dtype, 0) for i, r in enumerate(ranks)
                 if i != me and int(np.prod(shapes[i]))])
            got = iter(pend.wait())
            return [blk[i] if i == me else
                    next(got) if int(np.prod(shapes[i])) else
                    torch.empty(shapes[i], dtype=dtype, device=t.device)
                    for i in range(len(ranks))]

        return self._timed(kind, run)

    def gather(self, x: torch.Tensor, dims: Sequence[str],
               kind: str) -> torch.Tensor:
        """Every member's ``x`` stacked in member order: (P, *x.shape)."""
        ranks = self.ranks(dims)
        if len(ranks) == 1:
            return x[None]
        t = self._transport(x.device)
        return self._timed(kind, lambda: t.gather_start(
            x.contiguous(), ranks, kind).wait())

    def gather_to(self, x: torch.Tensor, dims: Sequence[str], root: int,
                  kind: str = "reduce") -> Optional[List[torch.Tensor]]:
        """Every member's ``x`` (same shape on each), in member order, on
        the member whose global rank is ``root``; None on the others."""
        ranks = self.ranks(dims)
        me = self.rank
        if len(ranks) == 1:
            return [x]
        t = self._transport(x.device)
        x = x.contiguous()
        if me != root:
            self._timed(kind, lambda: t._exchange(kind, [(root, x, 1)],
                                                  []).wait())
            return None
        got = iter(self._timed(kind, lambda: t._exchange(
            kind, [], [(r, tuple(x.shape), x.dtype, 1) for r in ranks
                       if r != me]).wait()))
        return [x if r == me else next(got) for r in ranks]

    def reduce(self, x: torch.Tensor, dims: Sequence[str], op: str = "sum",
               kind: str = "reduce") -> torch.Tensor:
        """The element-wise sum or max of every member's ``x`` (same shape
        on each), the same bits on every member: each member reduces one
        chunk from every member in member order, then the chunks are
        gathered (a tensor of at most ``SMALL_REDUCE`` elements is
        gathered whole and reduced in member order on every member).
        ``max`` keeps a NaN wherever it sits."""
        fn = {"sum": torch.add, "max": torch.maximum}[op]
        p = self.size(dims)
        if p == 1:
            return x.clone()
        if x.numel() <= SMALL_REDUCE:
            # one round: every member reduces every block, in member order
            got = self.gather(x.reshape(-1), dims, kind)
            red = got[0]
            for g in got[1:]:
                red = fn(red, g)
            return red.reshape(x.shape)
        flat = x.reshape(-1)
        n = flat.numel()
        c = max(-(-n // p), 1)
        padded = torch.zeros(c * p, dtype=x.dtype, device=x.device)
        padded[:n] = flat
        got = self.exchange(list(padded.view(p, c)), dims, kind)
        red = got[0]
        for g in got[1:]:
            red = fn(red, g)
        return self.gather(red, dims, kind).reshape(-1)[:n].reshape(x.shape)


# every live comm by its key: how the dispatcher ops reach one
_COMMS: "weakref.WeakValueDictionary[int, MeshComm]" = \
    weakref.WeakValueDictionary()
_KEYS = itertools.count()


def mesh_comm(mesh) -> MeshComm:
    """The one :class:`MeshComm` of ``mesh`` in this process: the one the
    mesh makes itself where it has a ``make_comm`` (the dry-run's stand-in,
    ``launch.dryrun.DryMesh``, whose comm moves nothing), else a
    :class:`MeshComm` over the process group. The mesh keeps it, so it
    goes with the mesh."""
    comm = getattr(mesh, "_mesh_comm", None)
    if comm is None:
        make = getattr(mesh, "make_comm", None)
        comm = mesh._mesh_comm = make() if make else MeshComm(mesh)
    return comm


def _tiled_a2a(comm, x, dims, split_dim, cat_dim, kind):
    p = comm.size(dims)
    got = comm.exchange(list(x.chunk(p, dim=split_dim)), dims, kind)
    return torch.cat(got, dim=cat_dim)


def _sum_members(got):
    """The received blocks summed in member order."""
    out = got[0]
    for g in got[1:]:
        out = out + g
    return out


def _reduce_scatter(comm, x, dims, kind):
    return _sum_members(comm.exchange(list(x.chunk(comm.size(dims), dim=0)),
                                      dims, kind))


def _gather_cat(comm, x, dims, kind):
    g = comm.gather(x, dims, kind)
    return g.reshape((-1,) + tuple(x.shape[1:]))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dims, kind):
        ctx.args = (comm, dims, kind)
        return _gather_cat(comm, x, dims, kind)

    @staticmethod
    def backward(ctx, g):
        comm, dims, kind = ctx.args
        return _reduce_scatter(comm, g, dims, kind), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dims, kind):
        ctx.args = (comm, dims, kind)
        return _reduce_scatter(comm, x, dims, kind)

    @staticmethod
    def backward(ctx, g):
        comm, dims, kind = ctx.args
        return _gather_cat(comm, g, dims, kind), None, None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, dims, at, dtype, *xs):
        ctx.args = (comm, dims, at, [x.dtype for x in xs])
        p = comm.size(dims)
        flat = torch.cat([x.to(dtype).reshape(-1) for x in xs])
        got = comm.gather(flat, dims, "fsdp")               # (P, n)
        out, off = [], 0
        for x, d in zip(xs, at):
            n = x.numel()
            shape = list(x.shape)
            shape[d] *= p
            out.append(got[:, off:off + n].reshape((p,) + tuple(x.shape))
                       .movedim(0, d).reshape(shape))
            off += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        comm, dims, at, dtypes = ctx.args
        p = comm.size(dims)
        # member i's block of every leaf, flattened in leaf order
        parts = [g.float().chunk(p, dim=d) for g, d in zip(gs, at)]
        red = _sum_members(comm.exchange(
            [torch.cat([c[i].reshape(-1) for c in parts]) for i in range(p)],
            dims, "fsdp"))
        grads, off = [], 0
        for c, dt in zip(parts, dtypes):
            n = c[0].numel()
            grads.append(red[off:off + n].reshape(c[0].shape).to(dt))
            off += n
        return (None, None, None, None, *grads)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dims, kind):
        return comm.reduce(x, dims, "sum", kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dims, kind):
        ctx.args = (comm, dims, kind)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        comm, dims, kind = ctx.args
        return (comm.reduce(g.float(), dims, "sum", kind).to(g.dtype), None,
                None, None)


def _gather_dim(comm, x, dims, dim, kind):
    """Every member's ``x`` joined along ``dim`` in member order."""
    g = comm.gather(x, dims, kind).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= comm.size(dims)
    return g.reshape(shape)


def _own_block(comm, x, dims, dim):
    n = x.shape[dim] // comm.size(dims)
    return x.narrow(dim, comm.index(dims) * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dims, dim, kind):
        ctx.args = (comm, dims, dim)
        return _gather_dim(comm, x, dims, dim, kind)

    @staticmethod
    def backward(ctx, g):
        comm, dims, dim = ctx.args
        return (_own_block(comm, g, dims, dim).contiguous(), None, None,
                None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dims, dim, kind):
        ctx.args = (comm, dims, dim, kind)
        return _own_block(comm, x, dims, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        comm, dims, dim, kind = ctx.args
        return _gather_dim(comm, g, dims, dim, kind), None, None, None, None


def _a2a_impl(x: torch.Tensor, comm: int, dims: str, split_dim: int,
              cat_dim: int, kind: str) -> torch.Tensor:
    return _tiled_a2a(_COMMS[comm], x, tuple(dims.split(",")), split_dim,
                      cat_dim, kind)


def _exchange_impl(x: torch.Tensor, comm: int, dims: str,
                   kind: str) -> torch.Tensor:
    c = _COMMS[comm]
    dims_t = tuple(dims.split(","))
    return torch.stack(c.exchange(list(x.chunk(c.size(dims_t))), dims_t,
                                  kind))


_a2a_op = torch.library.custom_op(
    "repro_torch::all_to_all", _a2a_impl, mutates_args=())
_exchange_op = torch.library.custom_op(
    "repro_torch::exchange", _exchange_impl, mutates_args=())
# under fake tensors the comm runs as it is (the dry-run's comm counts and
# hands back empty blocks of the peers' shapes)
_a2a_op.register_fake(_a2a_impl)
_exchange_op.register_fake(_exchange_impl)


def _a2a_context(ctx, inputs, output):
    ctx.args = inputs[1:]


def _a2a_backward(ctx, g):
    comm, dims, split_dim, cat_dim, kind = ctx.args
    return (_a2a_op(g, comm, dims, cat_dim, split_dim, kind), None, None,
            None, None, None)


_a2a_op.register_autograd(_a2a_backward, setup_context=_a2a_context)

# the ops, as a selective checkpoint policy sees them; an all-to-all's
# kind is its last argument
ALL_TO_ALL = torch.ops.repro_torch.all_to_all.default
EXCHANGE = torch.ops.repro_torch.exchange.default


def all_to_all(x, comm: MeshComm, dims, split_dim: int, cat_dim: int,
               kind: str = "a2a"):
    """``jax.lax.all_to_all(tiled=True)`` over ``dims``: ``x`` cut into P
    blocks along ``split_dim``, block i sent to member i, the received
    blocks joined along ``cat_dim`` in member order. Backward: the reverse
    all-to-all. A dispatcher op (:data:`ALL_TO_ALL`)."""
    return _a2a_op(x, comm.key, ",".join(dims), split_dim, cat_dim, kind)


def dispatch_exchange(x, comm: MeshComm, dims, kind: str = "rows"):
    """``x`` cut into P blocks along dim 0, block i sent to member i; the
    received blocks stacked in member order: (P, *block), as a dispatcher
    op (:data:`EXCHANGE`; no gradient). The MoE dispatch's live-row
    counts."""
    return _exchange_op(x, comm.key, ",".join(dims), kind)


def all_gather_cat(x, comm: MeshComm, dims, kind: str = "reduce",
                   dim: int = 0):
    """Every member's ``x`` joined along ``dim`` in member order.
    Backward: the gradient's member blocks summed over members (a
    reduce-scatter): each member's gradient is its share of the one the
    joined tensor has."""
    if dim:
        return _AllGather.apply(x.movedim(dim, 0), comm, tuple(dims),
                                kind).movedim(0, dim)
    return _AllGather.apply(x, comm, tuple(dims), kind)


def reduce_scatter(x, comm: MeshComm, dims, kind: str = "reduce"):
    """``x`` (P·b, …) cut into P blocks along dim 0; member i gets the sum
    over members of their block i, in member order. Backward: an
    all-gather."""
    return _ReduceScatter.apply(x, comm, tuple(dims), kind)


def fsdp_gather(xs: Sequence[torch.Tensor], comm: MeshComm, dims,
                at: Sequence[int], dtype: torch.dtype) -> List[torch.Tensor]:
    """Parameter slices gathered whole, in one transfer: every member's
    ``xs`` cast to ``dtype`` (so the wire carries the compute dtype), leaf
    ``j`` joined along dim ``at[j]`` in member order. Backward: each whole
    leaf's cotangent in float32, its member blocks along ``at[j]`` summed
    over members in member order (one float32 reduce-scatter for all the
    leaves), returned in each slice's dtype. Counted under ``"fsdp"``."""
    return list(_FsdpGather.apply(comm, tuple(dims), tuple(at), dtype, *xs))


def psum(x, comm: MeshComm, dims, kind: str = "reduce"):
    """The sum over members (same bits on each). Backward: the identity —
    the sum feeds an objective that every member holds whole, and each
    member carries the gradient back to its own term. Megatron's output
    operator (``g``) of a row-split product."""
    return _PSum.apply(x, comm, tuple(dims), kind)


def tp_copy(x, comm: MeshComm, dims, kind: str = "tp"):
    """Megatron's input operator (``f``): the identity forward; backward
    the sum over members of the gradient, in float32, in the gradient's
    dtype. ``x`` is the same on every
    member and each member computes only its part of what depends on it
    (its columns of a column-split product, its heads), so its gradient
    there is a part of the whole one."""
    return _Copy.apply(x, comm, tuple(dims), kind)


def tp_gather(x, comm: MeshComm, dims, dim: int, kind: str = "tp"):
    """Every member's ``x`` joined along ``dim`` in member order, for a
    consumer every member runs whole (each holds the whole gradient).
    Backward: this member's block of the gradient."""
    return _Gather.apply(x, comm, tuple(dims), dim, kind)


def tp_split(x, comm: MeshComm, dims, dim: int, kind: str = "tp"):
    """This member's block of ``x`` along ``dim`` (``x`` the same on every
    member, the dim divisible by the member count). Backward: the
    members' gradient blocks joined (an all-gather), the whole gradient on
    every member."""
    return _Split.apply(x, comm, tuple(dims), dim, kind)
