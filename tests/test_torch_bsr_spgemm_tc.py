"""The tensor-core routes of the port's bsr_spgemm, rehearsed on the CPU.

The card's ``csrc/bsr_spgemm_tc.cu`` (bs 64/128) and
``csrc/bsr_spgemm_warp.cu`` (bs 16/32) cannot run here; their arithmetic,
which is one, can.
``ref.tf32_split`` is the kernel's ``cvt.rna.tf32.f32`` split in bit
operations, and ``ref.bsr_spgemm_tc_model`` its per-k-panel sum of hi·hi,
hi·lo, lo·hi and lo·lo (lo passes skipped where lo is all zero; a panel
with an infinity, a NaN or an |x| >= 2**127 multiplied unsplit; bool
booleanized, summed over the run and clipped). Both are held, on seeded
numpy inputs, against the reference's ``bsr_spgemm_pallas`` in interpret
mode and the port's plain ``bsr_spgemm_ref``.

Tolerances: integer-valued tiles compare bitwise (every TF32 term is exact
and every partial sum is an integer below 2**24); standard-normal tiles
within rtol 1e-5, atol 1e-4, the tolerance ``chip_smoke.py`` holds the
card to (the split keeps about 22 of each factor's 24 bits and the sums
run in another order); bool always bitwise.
"""

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
from repro_torch.kernels.bsr_spgemm.ref import (bsr_spgemm_ref,
                                                bsr_spgemm_tc_model,
                                                tf32_split)

TC_SEMIRINGS = ("plus_times", "bool_or_and")
NA = NB = 5
NRUNS = 6
NC = 17          # output slots: runs land on a sorted subset, gaps between
# runs of 1-3 products; one pattern for every case, so the reference's jit
# caches compile each static shape once
RUN_LENS = np.array([2, 1, 3, 1, 2, 1])


def _schedule(rng, lens=RUN_LENS, nc=NC):
    """Runs sorted by output slot on a random subset of ``nc`` slots, with
    random payload slots."""
    slots = np.sort(rng.choice(nc - 1, size=len(lens), replace=False))
    c_slot = np.repeat(slots, lens).astype(np.int32)
    a_slot = rng.integers(0, NA, size=len(c_slot)).astype(np.int32)
    b_slot = rng.integers(0, NB, size=len(c_slot)).astype(np.int32)
    return a_slot, b_slot, c_slot, np.concatenate([[0], np.cumsum(lens)])


def _tiles(rng, n, bs, kind):
    vals = (rng.integers(-3, 4, size=(n, bs, bs)) if kind == "int"
            else rng.standard_normal((n, bs, bs))).astype(np.float32)
    vals[rng.random((n, bs, bs)) < 0.4] = 0.0
    return vals


def _pallas(a, b, a_slot, b_slot, c_slot, srname, nc, bs, seg_start, nprod):
    J = jnp.asarray
    return np.asarray(bsr_spgemm_pallas(
        J(a), J(b), J(a_slot), J(b_slot), J(c_slot),
        J(tbs.flags_from_c_slot(c_slot)), nprod=nprod, nc=nc, bs=bs,
        interpret=True, semiring=rsr.by_name(srname), seg_start=seg_start))


def _compare(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bs", [16, 32, 64, 128])
@pytest.mark.parametrize("srname", ["plus_times", "bool_or_and",
                                    "min_plus"])
def test_route_table(srname, bs):
    """The route depends on (semiring, bs) alone: every semiring at bs
    16/32 on the warp-per-run kernel, plus-times and bool at bs 64/128 on
    the warpgroup tensor-core kernel, min-plus at bs 64/128 on the
    CUDA-core kernel that shares k-panels among persistent CTAs."""
    want = ("warp" if bs in (16, 32) else
            "tc" if srname in TC_SEMIRINGS else "minplus")
    assert tkernel.route(tsr.by_name(srname), bs) == want
    assert tkernel.ROUTES == ("tc", "warp", "minplus")


def test_tf32_split_is_exact_on_integers_below_2_22():
    x = torch.arange(-2 ** 22 + 1, 2 ** 22, dtype=torch.float64).float()
    hi, lo = tf32_split(x)
    assert torch.equal(hi.double() + lo.double(), x.double())
    for part in (hi, lo):      # what wgmma reads: the top 19 bits only
        assert not bool((part.view(torch.int32) & 0x1FFF).any())


def test_tf32_split_lo_is_zero_up_to_2048_and_off_the_finite():
    small = torch.arange(-2048, 2049).float()
    hi, lo = tf32_split(small)
    assert torch.equal(hi, small) and not bool(lo.any())
    odd = torch.arange(2049, 4095, 2).float()     # past TF32's 11 bits
    assert bool((tf32_split(odd)[1] != 0).all())
    x = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi, lo = tf32_split(x)
    assert hi[0] == float("inf") and hi[1] == -float("inf")
    assert torch.isnan(hi[2]) and not bool(lo.any())


def test_tf32_split_rounds_to_nearest_ties_away():
    """hi is x rounded to 11 significant bits, ties away from zero (the
    .rna of cvt), as a float64 reference computes it."""
    rng = np.random.default_rng(7)
    v = (rng.standard_normal(20000)
         * 10.0 ** rng.integers(-30, 30, 20000)).astype(np.float32)
    ties = np.arange(2049, 4095, 2, dtype=np.float32)  # halfway cases
    v = np.concatenate([v, ties, -ties])
    m, e = np.frexp(v.astype(np.float64))
    t = m * 2 ** 11
    want = np.ldexp(np.sign(t) * np.floor(np.abs(t) + 0.5) / 2 ** 11, e)
    hi, lo = tf32_split(torch.from_numpy(v))
    np.testing.assert_array_equal(hi.numpy(), want.astype(np.float32))
    # 2049, 2051, 2053 lie halfway between TF32 neighbours: away from 0
    np.testing.assert_array_equal(hi.numpy()[-2 * len(ties):][:3],
                                  [2050.0, 2052.0, 2054.0])


@pytest.mark.parametrize("window", ["full", "offset"])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
@pytest.mark.parametrize("srname", TC_SEMIRINGS)
def test_tc_model_matches_reference_paths(srname, bs, kind, window):
    """The model of the card's arithmetic (the ``tc`` route at bs 64/128,
    the ``warp`` route at bs 16/32, where a product is one k-panel) against
    the Pallas kernel and the port's plain version, on windows whose runs
    leave gaps between their output slots: visited slots agree (bitwise on
    integers and bool), every other slot holds the identity."""
    rng = np.random.default_rng([bs, len(srname), len(kind), len(window)])
    a_slot, b_slot, c_slot, starts = _schedule(rng)
    a, b = _tiles(rng, NA, bs, kind), _tiles(rng, NB, bs, kind)
    seg_start, nprod = {"full": (0, len(c_slot)),
                        "offset": (int(starts[1]),
                                   int(starts[NRUNS - 1] - starts[1]))}[window]
    ts = tsr.by_name(srname)
    T = torch.from_numpy
    got = bsr_spgemm_tc_model(T(a), T(b), T(a_slot), T(b_slot), T(c_slot),
                              nc=NC, semiring=ts, seg_start=seg_start,
                              seg_len=nprod).numpy()
    port = bsr_spgemm_ref(T(a), T(b), T(a_slot), T(b_slot), T(c_slot),
                          nc=NC, semiring=ts, seg_start=seg_start,
                          seg_len=nprod).numpy()
    exact = kind == "int" or srname == "bool_or_and"
    _compare(got, port, exact)
    visited = np.unique(c_slot[seg_start:seg_start + nprod])
    unvisited = np.setdiff1d(np.arange(NC), visited)
    assert len(unvisited) > NC // 2 and np.all(got[unvisited] == ts.zero)
    want = _pallas(a, b, a_slot, b_slot, c_slot, srname, NC, bs, seg_start,
                   nprod)
    _compare(got[visited], want[visited], exact)


def _odd_tiles(rng, n, bs):
    """Tiles with one nonzero per row and column, odd integers in
    2049..4093: not TF32-exact (lo = +-1), and every exact product of two
    of them stays below 2**24."""
    tiles = np.zeros((n, bs, bs), np.float32)
    for t in range(n):
        tiles[t, np.arange(bs), rng.permutation(bs)] = \
            rng.integers(1024, 2047, size=bs) * 2 + 1
    return tiles


@pytest.mark.parametrize("bs", [64, 128])
def test_four_terms_exact_where_three_are_not(bs):
    """Odd integers past 2048 need the lo.lo term: with four terms the
    model is bitwise equal to the plain version and the Pallas kernel; with
    three (or hi.hi alone) it is not."""
    rng = np.random.default_rng(bs)
    a, b = _odd_tiles(rng, NA, bs), _odd_tiles(rng, NB, bs)
    lens = np.ones(4, dtype=np.int64)           # runs of one product
    a_slot, b_slot, c_slot, _ = _schedule(rng, lens=lens, nc=9)
    T = torch.from_numpy
    args = (T(a), T(b), T(a_slot), T(b_slot), T(c_slot))
    port = bsr_spgemm_ref(*args, nc=9).numpy()
    assert port.max() < 2 ** 24 and port.max() > 2049 ** 2
    got = bsr_spgemm_tc_model(*args, nc=9).numpy()
    _compare(got, port, exact=True)
    want = _pallas(a, b, a_slot, b_slot, c_slot, "plus_times", 9, bs, 0,
                   len(c_slot))
    _compare(got[c_slot], want[c_slot], exact=True)
    for terms in (3, 1):
        fewer = bsr_spgemm_tc_model(*args, nc=9, terms=terms).numpy()
        assert not np.array_equal(fewer, port), terms


def _same_or_nan(got, want):
    """Bitwise equal, a NaN matching any NaN (its sign and payload are not
    part of the result)."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def _plant(rng, tiles, values):
    """Each tile with one element set to ``values[t % len(values)]``, at a
    random place."""
    tiles = tiles.copy()
    for t in range(len(tiles)):
        r, c = rng.integers(0, tiles.shape[1], size=2)
        tiles[t, r, c] = values[t % len(values)]
    return tiles


def test_split_breaks_the_nonfinite_rules():
    """Why the kernel keeps a panel with an infinity, a NaN or an |x| >=
    2**127 off the split: inf against 2049 (hi 2050, lo -1) sums inf and
    -inf where fp32 gives inf, and FLT_MAX rounds its hi to infinity."""
    inf = torch.tensor([float("inf")])
    hi, lo = tf32_split(torch.tensor([2049.0]))
    assert float(hi) == 2050.0 and float(lo) == -1.0
    assert bool(torch.isnan(inf * hi + inf * lo)) and float(inf * 2049) > 0
    hi, lo = tf32_split(torch.tensor([torch.finfo(torch.float32).max]))
    assert bool(torch.isinf(hi)) and bool(torch.isnan(hi + lo))


@pytest.mark.parametrize("kind", ["int", "odd"])
@pytest.mark.parametrize("bs", [64, 128])
def test_nonfinite_and_huge_values_propagate_as_the_plain_version(bs, kind):
    """Infinities and NaNs in A and B, among odd integers past 2048 (whose
    lo is -1 or 1) or integers; with integers, also finite values >=
    2**127 in A (FLT_MAX, whose hi rounds to infinity, and -1.5 * 2**127)
    against B in -1..1: the model, which sums such panels unsplit in
    float32 as the kernel does on its CUDA cores, gives the plain
    version's and the Pallas kernel's infinities and NaNs, and their
    finite values bitwise. No product overflows (a fused multiply-add and
    a rounded product disagree there), and runs of one product leave each
    output element at most one huge finite term, so no sum depends on its
    order."""
    rng = np.random.default_rng([bs, len(kind), 5])
    inf = np.float32(np.inf)
    if kind == "odd":
        a, b = _odd_tiles(rng, NA, bs), _odd_tiles(rng, NB, bs)
        a = _plant(rng, a, [inf, -inf, np.nan])
    else:
        a, b = _tiles(rng, NA, bs, "int"), _tiles(rng, NB, bs, "int")
        b = np.clip(b, -1, 1)
        a = _plant(rng, a, [inf, -inf, np.nan, np.finfo(np.float32).max,
                            np.float32(-1.5 * 2.0 ** 127)])
    b = _plant(rng, b, [np.nan, inf, -inf])
    a_slot, b_slot, c_slot, _ = _schedule(
        rng, lens=np.ones(8, dtype=np.int64), nc=11)
    T = torch.from_numpy
    args = (T(a), T(b), T(a_slot), T(b_slot), T(c_slot))
    port = bsr_spgemm_ref(*args, nc=11).numpy()
    got = bsr_spgemm_tc_model(*args, nc=11).numpy()
    _same_or_nan(got, port)
    for test in (np.isnan, np.isposinf, np.isneginf, np.isfinite):
        assert test(port[c_slot]).any(), test   # every outcome occurs
    want = _pallas(a, b, a_slot, b_slot, c_slot, "plus_times", 11, bs, 0,
                   len(c_slot))
    _same_or_nan(got[c_slot], want[c_slot])


# operand pairs at overflow magnitudes: x = nextafter(2**64, 0), whose TF32
# hi rounds up to 2**64, so hi.hi = 2**128 overflows where x * x does not;
# 2e19 squared, past FLT_MAX in both; 2**63 times nextafter(2**65, 0), whose
# product is FLT_MAX; two exact products below 2**127, one under the
# kernels' 2**126 pair bound and one over it
_X = float(np.nextafter(np.float32(2.0 ** 64), np.float32(0)))
OVERFLOW_PAIRS = [(_X, _X), (-_X, _X), (2e19, 2e19),
                  (2.0 ** 63, float(np.nextafter(np.float32(2.0 ** 65),
                                                 np.float32(0)))),
                  (2.0 ** 100, 2.0 ** 20), (3 * 2.0 ** 62, 2.0 ** 63)]


def overflow_case(bs):
    """One A and one B tile per pair of :data:`OVERFLOW_PAIRS`, each
    diagonal: small nonzero integers, and the pair at one place of the
    diagonal (a different k-panel from tile to tile). Products ``t`` of A
    tile t and B tile t, runs of one product, so every output element has
    one nonzero term and a fused multiply-add and a rounded product agree.
    Returns the tiles, the slots and the output slot count."""
    rng = np.random.default_rng(bs)
    n = len(OVERFLOW_PAIRS)
    a = np.zeros((n, bs, bs), np.float32)
    b = np.zeros((n, bs, bs), np.float32)
    for t, (x, y) in enumerate(OVERFLOW_PAIRS):
        d = (37 * t + 5) % bs
        a[t, np.arange(bs), np.arange(bs)] = rng.choice([-3, -2, -1, 1, 2, 3],
                                                        size=bs)
        b[t, np.arange(bs), np.arange(bs)] = rng.choice([-3, -2, -1, 1, 2, 3],
                                                        size=bs)
        a[t, d, d], b[t, d, d] = x, y
    nc = n + 3
    c_slot = np.sort(rng.choice(nc - 1, size=n, replace=False)).astype(
        np.int32)
    slots = np.arange(n, dtype=np.int32)
    return a, b, slots, slots.copy(), c_slot, nc


@pytest.mark.parametrize("bs", [16, 32, 64, 128])
@pytest.mark.parametrize("srname", TC_SEMIRINGS)
def test_products_near_overflow_match_the_plain_version(srname, bs):
    """A panel whose largest A and B magnitudes multiply to 2**126 or more
    is summed unsplit, as the kernels sum it: where the split's hi.hi
    overflows (x * x, -x * x, 2**63 * nextafter(2**65, 0) = FLT_MAX) the
    model gives the finite float32 product, bitwise equal to the plain
    version and to the Pallas kernel; where both overflow (2e19 squared) it
    gives infinity; exact products below 2**127 stay exact on either side
    of the bound. bool booleanizes first and cannot overflow."""
    a, b, a_slot, b_slot, c_slot, nc = overflow_case(bs)
    ts = tsr.by_name(srname)
    T = torch.from_numpy
    args = (T(a), T(b), T(a_slot), T(b_slot), T(c_slot))
    port = bsr_spgemm_ref(*args, nc=nc, semiring=ts).numpy()
    got = bsr_spgemm_tc_model(*args, nc=nc, semiring=ts).numpy()
    _same_or_nan(got, port)
    want = _pallas(a, b, a_slot, b_slot, c_slot, srname, nc, bs, 0,
                   len(c_slot))
    _same_or_nan(got[c_slot], want[c_slot])
    if srname == "plus_times":
        diag = port[c_slot][:, np.arange(bs), np.arange(bs)]
        fmax = np.finfo(np.float32).max
        with np.errstate(over="ignore"):       # 2e19 squared is inf
            for t, (x, y) in enumerate(OVERFLOW_PAIRS):
                assert np.float32(x) * np.float32(y) in diag[t], (t, x, y)
        assert fmax in diag and -np.float32(_X) ** 2 in diag
        assert np.isposinf(diag).sum() == 1
        assert np.isfinite(port[c_slot][~np.isposinf(port[c_slot])]).all()


def test_bool_sum_then_clip_equals_clip_then_max():
    """Runs of up to 8 products: the kernel sums the booleanized products
    over the run and clips once; the plain version clips each product and
    takes the max. Every term is >= 0, so the two agree bitwise."""
    rng = np.random.default_rng(11)
    bs = 64
    lens = np.array([8, 1, 5, 2, 8])
    a_slot, b_slot, c_slot, _ = _schedule(rng, lens=lens, nc=8)
    a, b = _tiles(rng, NA, bs, "float"), _tiles(rng, NB, bs, "float")
    a[0, :3] = np.nan                  # NaN != 0: a true entry
    T = torch.from_numpy
    args = (T(a), T(b), T(a_slot), T(b_slot), T(c_slot))
    got = bsr_spgemm_tc_model(*args, nc=8, semiring=tsr.BOOL_OR_AND)
    want = bsr_spgemm_ref(*args, nc=8, semiring=tsr.BOOL_OR_AND)
    assert torch.equal(got, want)
    ones = [T((t != 0).astype(np.float32)) for t in (a, b)]
    summed = bsr_spgemm_tc_model(*ones, *args[2:], nc=8)
    assert float(summed.max()) > 1.0   # the unclipped sums do pass 1


def test_integer_payloads_need_one_pass():
    """Every value the Laplacian path and the integer grids carry (-3..3,
    the Laplacian's 4 and -1 and their doubles, bool's 0/1) is TF32-exact:
    lo is zero, so the kernel skips every lo pass."""
    vals = torch.tensor([-3., -2., -1., 0., 1., 2., 3., 4., 8., -4., 16.])
    hi, lo = tf32_split(vals)
    assert torch.equal(hi, vals) and not bool(lo.any())
    scaled = tf32_split(vals * (1 + 2 ** -12))[1]
    assert bool((scaled[vals != 0] != 0).all())  # the timing's float payload


def test_tc_source_hashes_the_shared_header():
    """Every bsr_spgemm source takes the NaN-propagating min and the other
    rules from ``tile_rules.cuh``, and the split from ``hopper.cuh``, which
    the rules include: both are hashed into each library."""
    header = (tkernel.SOURCE.parents[3] / "kernels" / "hopper.cuh").resolve()
    rules = tkernel.SOURCE.with_name("tile_rules.cuh").resolve()
    assert tkernel.SOURCES == (tkernel.SOURCE, tkernel.TC_SOURCE,
                               tkernel.WARP_SOURCE, tkernel.MINPLUS_SOURCE)
    for src in tkernel.SOURCES:
        assert set(cuda_lib.local_headers(src)) == {header, rules}, src


def test_warp_source_is_built_and_hashes_its_headers():
    """The warp route's source is one of the sources ``build`` compiles,
    and its library's name hashes the source, ``tile_rules.cuh``,
    ``hopper.cuh`` (which the rules include) and the flags, so an edit to
    either header builds it anew on a card."""
    import hashlib

    src = tkernel.WARP_SOURCE
    assert src.exists() and src in tkernel.SOURCES
    hopper = (src.parents[3] / "kernels" / "hopper.cuh").resolve()
    rules = src.with_name("tile_rules.cuh").resolve()
    assert cuda_lib.local_headers(src) == [rules, hopper]

    def named(headers):
        digest = hashlib.sha256(src.read_bytes())
        for header in headers:
            digest.update(header.read_bytes())
        digest.update(" ".join(cuda_lib.NVCC_FLAGS).encode())
        return f"bsr_spgemm_warp-{digest.hexdigest()[:16]}.so"

    assert cuda_lib.library_path(src).name == named([rules, hopper])
    assert named([rules]) != named([rules, hopper])


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("srname", ["plus_times", "bool_or_and",
                                    "min_plus"])
def test_cpu_wrapper_counts_no_warp_launch(srname, bs):
    """At the warp route's bs a CPU tensor takes the plain version, because
    it lies on the CPU: the result is ``bsr_spgemm_ref``'s, unvisited slots
    hold the identity, and no route counts a launch."""
    rng = np.random.default_rng([bs, len(srname)])
    a_slot, b_slot, c_slot, _ = _schedule(rng)
    ts = tsr.by_name(srname)
    T = torch.from_numpy
    a, b = T(_tiles(rng, NA, bs, "int")), T(_tiles(rng, NB, bs, "int"))
    rs = T(tkernel.run_starts_from_flags(tbs.flags_from_c_slot(c_slot), 0,
                                         len(c_slot)))
    before = (tkernel.bsr_spgemm.launches,
              dict(tkernel.bsr_spgemm.route_launches))
    out = tkernel.bsr_spgemm(a, b, T(a_slot), T(b_slot), T(c_slot), rs,
                             nprod=len(c_slot), nc=NC, bs=bs, semiring=ts)
    assert tkernel.route(ts, bs) == "warp"
    assert (tkernel.bsr_spgemm.launches,
            tkernel.bsr_spgemm.route_launches) == before
    want = bsr_spgemm_ref(a, b, T(a_slot), T(b_slot), T(c_slot), nc=NC,
                          semiring=ts)
    assert torch.equal(out, want)
    unvisited = np.setdiff1d(np.arange(NC), c_slot)
    assert bool((out[T(unvisited)] == ts.zero).all())


@pytest.mark.parametrize("bs", [16, 32])
def test_min_plus_any_product_order_matches_pallas(bs):
    """The warp kernel sums a run's min-plus products in its own order, and
    propagates a NaN as ``jnp.minimum`` does: the plain version over the
    schedule with the products of every run reversed or shuffled is bitwise
    equal (a NaN matching any NaN) to the Pallas kernel over the schedule
    as planned, with infinities (the identity) and NaNs among integer
    payloads."""
    rng = np.random.default_rng([bs, 17])
    lens = np.array([3, 1, 4, 2, 5, 1])
    a_slot, b_slot, c_slot, starts = _schedule(rng, lens=lens)
    a = _tiles(rng, NA, bs, "int")
    b = _tiles(rng, NB, bs, "int")
    for t in (a, b):
        t[rng.random(t.shape) < 0.3] = np.inf
    a = _plant(rng, a, [np.nan, 1.0])
    want = _pallas(a, b, a_slot, b_slot, c_slot, "min_plus", NC, bs, 0,
                   len(c_slot))
    assert np.isnan(want).any() and np.isfinite(want).any()
    T = torch.from_numpy
    for order in ("reversed", "shuffled"):
        perm = np.concatenate([
            np.arange(s0, s1)[::-1] if order == "reversed" else
            rng.permutation(np.arange(s0, s1))
            for s0, s1 in zip(starts[:-1], starts[1:])])
        got = bsr_spgemm_ref(T(a), T(b), T(a_slot[perm]), T(b_slot[perm]),
                             T(c_slot[perm]), nc=NC,
                             semiring=tsr.MIN_PLUS).numpy()
        _same_or_nan(got[c_slot], want[c_slot])


def test_cpu_wrapper_counts_no_route_launch():
    a = torch.zeros(3, 64, 64)
    slots = torch.zeros(2, dtype=torch.int32)
    before = dict(tkernel.bsr_spgemm.route_launches)
    out = tkernel.bsr_spgemm(a, a.clone(), slots, slots, slots,
                             torch.tensor([0, 2], dtype=torch.int32),
                             nprod=2, nc=2, bs=64)
    assert torch.equal(out, torch.zeros(2, 64, 64))
    assert tkernel.bsr_spgemm.route_launches == before


def test_launch_args_refuse_empty_stacks():
    slots = torch.zeros(2, dtype=torch.int32)
    kw = dict(a_slot=slots, b_slot=slots, c_slot=slots,
              run_starts=torch.tensor([0, 2], dtype=torch.int32),
              nprod=2, nc=1, bs=64, semiring=tsr.PLUS_TIMES, seg_start=0)
    tkernel.check_launch_args(torch.zeros(1, 64, 64), torch.zeros(1, 64, 64),
                              out=torch.zeros(1, 64, 64), **kw)
    with pytest.raises(ValueError, match="at least one"):
        tkernel.check_launch_args(torch.zeros(0, 64, 64),
                                  torch.zeros(1, 64, 64),
                                  out=torch.zeros(1, 64, 64), **kw)
