"""The min-plus route of the port's bsr_spgemm at bs 64 and 128, rehearsed
on the CPU.

The card's ``csrc/bsr_spgemm_minplus.cu`` cannot run here. What surrounds
its arithmetic can: the route table, the build's hashing of its headers,
the split of a window into worker shares of k-panels
(``kernel.minplus_shares``, the kernel's own arithmetic in numpy), the
min-combine of the pieces of a run that a share bound cuts
(``ref.bsr_spgemm_minplus_model``, with the plain version doing each
piece), and what ``_launch`` hands a stubbed library.

Tolerance: bitwise, a NaN matching any NaN. Each term is one float32 add
and min is order-free, so min-plus is exact in any order of its terms.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.semiring as rsr
from repro.kernels.bsr_spgemm.kernel import bsr_spgemm_pallas
from repro_torch.core import blocksparse as tbs
from repro_torch.core import semiring as tsr
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.bsr_spgemm import kernel as tkernel
from repro_torch.kernels.bsr_spgemm.ref import (bsr_spgemm_minplus_model,
                                                bsr_spgemm_ref)

NA = NB = 6
# runs of 1-4 products, as the banded path makes them, and one of 24, which
# every worker count above 2 cuts
RUN_LENS = np.array([2, 1, 24, 3, 1, 4, 2])
WORKERS = [1, 3, 7, 64, 500]


def _case(rng, bs, lens=RUN_LENS, nc=None):
    """A schedule sorted by output slot, runs on a sorted random subset of
    ``nc`` slots (gaps between them), and integer tiles with +inf (the
    identity) and a NaN planted in A."""
    nc = nc or 3 * len(lens) + 2
    slots = np.sort(rng.choice(nc - 1, size=len(lens), replace=False))
    c_slot = np.repeat(slots, lens).astype(np.int32)
    a_slot = rng.integers(0, NA, size=len(c_slot)).astype(np.int32)
    b_slot = rng.integers(0, NB, size=len(c_slot)).astype(np.int32)
    a = rng.integers(-3, 4, size=(NA, bs, bs)).astype(np.float32)
    b = rng.integers(-3, 4, size=(NB, bs, bs)).astype(np.float32)
    for t in (a, b):
        t[rng.random(t.shape) < 0.3] = np.inf
    a[1, rng.integers(bs), rng.integers(bs)] = np.nan
    return a, b, a_slot, b_slot, c_slot, nc


def _windows(c_slot, nc):
    """(label, seg_start, run_starts, nc): the whole window; one starting at
    run 1 and ending one run early (a seg_start offset); the whole window
    with pad products after it, the ring's way (their run left out of the
    run starts); and a window of those pad products only (no run)."""
    flags = tbs.flags_from_c_slot(c_slot)
    starts = tkernel.run_starts_from_flags(flags, 0, len(c_slot))
    npad = 5
    pad_c = np.concatenate([c_slot, np.full(npad, nc - 1, np.int32)])
    pad_flags = tbs.flags_from_c_slot(pad_c)
    out = [("full", 0, starts),
           ("offset", int(starts[1]),
            tkernel.run_starts_from_flags(flags, int(starts[1]),
                                          int(starts[-2] - starts[1])))]
    for label, seg_start, nprod in (("padded", 0, len(pad_c)),
                                    ("pads only", len(c_slot), npad)):
        rs = tkernel.run_starts_from_flags(pad_flags, seg_start, nprod)
        if pad_c[rs[-2]] == nc - 1:
            rs = rs[:-1]
        out.append((label, seg_start, rs))
    return out, pad_c


def _same_or_nan(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_route_sends_min_plus_to_the_new_kernel(bs):
    """min_plus at bs 64/128 goes to ``"minplus"``; ``ROUTES`` lists it and
    not the first kernel, which ``_launch("simt", ...)`` still reaches."""
    want = "minplus" if bs in tkernel.TC_BS else "warp"
    assert tkernel.route(tsr.MIN_PLUS, bs) == want
    assert "minplus" in tkernel.ROUTES and "simt" not in tkernel.ROUTES
    assert set(tkernel.bsr_spgemm.route_launches) == set(tkernel.ROUTES)


def test_minplus_source_is_built_and_hashes_its_headers():
    """The route's source is one of the sources ``build`` compiles, and its
    library's name hashes the source, ``tile_rules.cuh`` and ``hopper.cuh``
    (which the rules include) and the flags, so an edit to either header
    builds it anew on a card."""
    src = tkernel.MINPLUS_SOURCE
    assert src.exists() and src in tkernel.SOURCES
    hopper = (src.parents[3] / "kernels" / "hopper.cuh").resolve()
    rules = src.with_name("tile_rules.cuh").resolve()
    assert cuda_lib.local_headers(src) == [rules, hopper]

    def named(headers):
        digest = hashlib.sha256(src.read_bytes())
        for header in headers:
            digest.update(header.read_bytes())
        digest.update(" ".join(cuda_lib.NVCC_FLAGS).encode())
        return f"bsr_spgemm_minplus-{digest.hexdigest()[:16]}.so"

    assert cuda_lib.library_path(src).name == named([rules, hopper])
    assert named([rules]) != named([rules, hopper])


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("bs", [64, 128])
def test_shares_are_balanced_and_cut_runs_only_where_combined(bs, workers):
    """Shares of k-panels differ by at most one panel and cover the
    window's real products; a share has a head (a piece the combine pass
    mins in) exactly where it starts strictly inside a run, and then it is
    that run; every run's first piece lies in a share with no head for it,
    so each run is written once and combined from all its pieces."""
    rng = np.random.default_rng([bs, workers])
    _, _, _, _, c_slot, nc = _case(rng, bs)
    kp = bs // tkernel.PANEL
    windows, _ = _windows(c_slot, nc)
    for label, _, rs in windows:
        bounds, heads = tkernel.minplus_shares(rs, workers, bs)
        total = (rs[-1] - rs[0]) * kp
        sizes = np.diff(bounds)
        assert bounds[0] == 0 and bounds[-1] == total, label
        assert sizes.min() >= 0 and sizes.max() - sizes.min() <= 1, label
        run_lo = (rs[:-1] - rs[0]) * kp       # panel bounds of each run
        run_hi = (rs[1:] - rs[0]) * kp
        for w in range(workers):
            inside = np.flatnonzero((run_lo < bounds[w])
                                    & (bounds[w] < run_hi))
            cut = sizes[w] > 0 and len(inside) == 1
            assert heads[w] == (inside[0] if cut else -1), (label, w)
        for r in range(len(rs) - 1):
            owner = np.searchsorted(bounds, run_lo[r], side="right") - 1
            assert heads[owner] != r and run_lo[r] < bounds[owner + 1]
            later = np.flatnonzero((bounds[:-1] > run_lo[r])
                                   & (bounds[:-1] < run_hi[r]) & (sizes > 0))
            assert np.all(heads[later] == r), (label, r)
    if workers >= 7:                      # the long run is cut somewhere
        assert (tkernel.minplus_shares(windows[0][2], workers, bs)[1]
                >= 0).any()


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("bs", [64, 128])
def test_min_combining_the_shares_is_the_whole_window(bs, workers):
    """The plain version over each share's pieces, each run's pieces then
    min-combined, equals the plain version over the whole window bitwise (a
    NaN as any NaN), with NaNs and +inf planted: for the whole window, a
    seg_start offset, gaps between the run slots and past the last, pad
    products after the runs and a window of pads only (every slot +inf)."""
    rng = np.random.default_rng([bs, workers, 1])
    a, b, a_slot, b_slot, c_slot, nc = _case(rng, bs)
    windows, pad_c = _windows(c_slot, nc)
    pad_a = np.concatenate([a_slot, a_slot[:5]])
    pad_b = np.concatenate([b_slot, b_slot[:5]])
    T = torch.from_numpy
    for label, seg_start, rs in windows:
        real = int(rs[-1] - seg_start)
        want = bsr_spgemm_ref(T(a), T(b), T(pad_a), T(pad_b), T(pad_c),
                              nc=nc, semiring=tsr.MIN_PLUS,
                              seg_start=seg_start, seg_len=real)
        if real == 0:
            want = torch.full((nc, bs, bs), float("inf"))
        got = bsr_spgemm_minplus_model(T(a), T(b), pad_a, pad_b, pad_c, rs,
                                       nc=nc, workers=workers)
        _same_or_nan(got, want)
        if label == "full":
            assert bool(torch.isnan(got).any())
            assert bool(torch.isfinite(got).any())
            unvisited = np.setdiff1d(np.arange(nc), c_slot)
            assert len(unvisited) > 0
            assert bool(torch.isposinf(got[unvisited]).all())


@pytest.mark.parametrize("bs", [64, 128])
def test_min_combining_the_shares_matches_pallas(bs):
    """The share model against the reference's Pallas kernel in interpret
    mode, on runs one of which seven workers cut, with NaNs planted."""
    rng = np.random.default_rng([bs, 3])
    lens = np.array([2, 5, 1])
    a, b, a_slot, b_slot, c_slot, nc = _case(rng, bs, lens=lens, nc=6)
    rs = tkernel.run_starts_from_flags(tbs.flags_from_c_slot(c_slot), 0,
                                       len(c_slot))
    assert (tkernel.minplus_shares(rs, 7, bs)[1] >= 0).any()
    T = torch.from_numpy
    got = bsr_spgemm_minplus_model(T(a), T(b), a_slot, b_slot, c_slot, rs,
                                   nc=nc, workers=7)
    J = jnp.asarray
    want = np.asarray(bsr_spgemm_pallas(
        J(a), J(b), J(a_slot), J(b_slot), J(c_slot),
        J(tbs.flags_from_c_slot(c_slot)), nprod=len(c_slot), nc=nc, bs=bs,
        interpret=True, semiring=rsr.MIN_PLUS))
    visited = np.unique(c_slot)
    _same_or_nan(got[visited], T(want[visited]))


class _StubLib:
    """Records the min-plus library calls ``_launch`` makes and writes
    nothing."""

    def __init__(self):
        self.calls = []

    def bsr_spgemm_minplus_launch(self, *args):
        self.calls.append(args)
        return 0

    def bsr_spgemm_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("bs", [64, 128])
def test_launch_fills_nothing_on_the_minplus_route(bs, monkeypatch):
    """With the library stubbed, ``_launch`` on ``"minplus"`` leaves the
    output as it was (the kernel writes every slot itself) and hands the
    library the window's runs, the output's slots and a scratch of one
    partial tile and one run index per worker; the first kernel,
    ``"simt"``, still gets the identity fill first."""
    stub = _StubLib()
    monkeypatch.setattr(tkernel, "_lib", {"minplus": stub, "simt": stub})
    monkeypatch.setattr(tkernel, "minplus_workers", lambda bs, device: 5)
    monkeypatch.setattr(tkernel.torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 7})())
    rng = np.random.default_rng(bs)
    a, b, a_slot, b_slot, c_slot, nc = _case(rng, bs)
    rs = tkernel.run_starts_from_flags(tbs.flags_from_c_slot(c_slot), 0,
                                       len(c_slot))
    T = torch.from_numpy
    args = (T(a), T(b), T(a_slot), T(b_slot), T(c_slot), T(rs))
    out = torch.full((nc, bs, bs), float("nan"))
    assert tkernel._launch("minplus", *args, out, bs=bs,
                           semiring=tsr.MIN_PLUS)
    assert bool(torch.isnan(out).all())
    (call,) = stub.calls
    assert call[0] == bs and call[7] == len(rs) - 1 and call[9] == nc
    assert call[12] == 5 and call[13] == 7
    assert tkernel._launch("simt", *args, out, bs=bs, semiring=tsr.MIN_PLUS)
    assert bool(torch.isposinf(out).all()) and len(stub.calls) == 2
