"""The port's bsr_spgemm (plain version, CPU wrapper, local op) against the
reference's three paths: ``repro.kernels.bsr_spgemm.ref.bsr_spgemm_ref``,
``bsr_spgemm_pallas(..., interpret=True)`` on one device, and the host
``repro.core.local_spgemm.spgemm``.

Tolerances: integer-valued tiles compare bitwise (every partial sum, min
and max is exact in float32); plus-times on general floats within
``rtol=1e-5`` (the summation order differs); bool and min-plus bitwise
always. The CUDA kernel itself runs only on a card (``chip_smoke.py``);
here the wrapper takes its plain version because the tensors lie on the
CPU, and its argument checks run on CPU tensors directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.blocksparse as rbs
import repro.core.local_spgemm as rls
import repro.core.semiring as rsr
import repro.core.sparse as rsp
from repro.kernels.bsr_spgemm.kernel import bsr_spgemm_pallas
from repro.kernels.bsr_spgemm.ops import \
    local_spgemm_device as r_local_spgemm_device
from repro.kernels.bsr_spgemm.ref import bsr_spgemm_ref as r_ref
from repro_torch.core import blocksparse as tbs
from repro_torch.core import semiring as tsr
from repro_torch.core.convert import blocksparse_from_arrays, csc_from_arrays
from repro_torch.kernels.bsr_spgemm import kernel as tkernel
from repro_torch.kernels.bsr_spgemm.ops import local_spgemm_device
from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

SEMIRINGS = ("plus_times", "bool_or_and", "min_plus")
NA = NB = 6
NRUNS = 8


# runs of 1-3 products per output slot; one length pattern for every case,
# so the reference's jit caches compile each static shape once
RUN_LENS = np.array([2, 1, 3, 1, 2, 3, 1, 2])


def _schedule(rng):
    """A schedule sorted by output slot with random payload slots."""
    lens = RUN_LENS
    c_slot = np.repeat(np.arange(NRUNS), lens).astype(np.int32)
    a_slot = rng.integers(0, NA, size=len(c_slot)).astype(np.int32)
    b_slot = rng.integers(0, NB, size=len(c_slot)).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)])
    return a_slot, b_slot, c_slot, starts


def _tiles(rng, n, bs, kind, zero):
    vals = (rng.integers(-3, 4, size=(n, bs, bs)) if kind == "int"
            else rng.standard_normal((n, bs, bs))).astype(np.float32)
    vals[rng.random((n, bs, bs)) < 0.4] = zero
    return vals


def _compare(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", ["full", "offset", "empty"])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("bs", [1, 16, 32])
@pytest.mark.parametrize("srname", SEMIRINGS)
def test_bsr_spgemm_matches_reference_paths(srname, bs, kind, window):
    ts, rs = tsr.by_name(srname), rsr.by_name(srname)
    rng = np.random.default_rng([bs, len(srname), len(kind), len(window)])
    a_slot, b_slot, c_slot, starts = _schedule(rng)
    a = _tiles(rng, NA, bs, kind, ts.zero)
    b = _tiles(rng, NB, bs, kind, ts.zero)
    flags = tbs.flags_from_c_slot(c_slot)
    seg_start, nprod = {"full": (0, len(c_slot)),
                        "offset": (int(starts[2]),
                                   int(starts[NRUNS - 2] - starts[2])),
                        "empty": (int(starts[1]), 0)}[window]
    visited = np.unique(c_slot[seg_start:seg_start + nprod])
    T = torch.from_numpy
    port = bsr_spgemm_ref(T(a), T(b), T(a_slot), T(b_slot), T(c_slot),
                          nc=NRUNS, semiring=ts, seg_start=seg_start,
                          seg_len=nprod).numpy()
    wrapped = tkernel.bsr_spgemm(
        T(a), T(b), T(a_slot), T(b_slot), T(c_slot),
        T(tkernel.run_starts_from_flags(flags, seg_start, nprod)),
        nprod=nprod, nc=NRUNS, bs=bs, semiring=ts,
        seg_start=seg_start).numpy()
    np.testing.assert_array_equal(wrapped, port)
    # slots the window does not visit hold the identity (semiring.zero)
    unvisited = np.setdiff1d(np.arange(port.shape[0]), visited)
    assert np.all(port[unvisited] == ts.zero)

    J = jnp.asarray
    want_ref = np.asarray(r_ref(J(a), J(b), J(a_slot), J(b_slot), J(c_slot),
                                nc=NRUNS, semiring=rs, seg_start=seg_start,
                                seg_len=nprod))
    exact = kind == "int" or srname != "plus_times"
    if nprod == 0:
        np.testing.assert_array_equal(port, want_ref)
        return
    _compare(port[visited], want_ref[visited], exact)
    want_pallas = np.asarray(bsr_spgemm_pallas(
        J(a), J(b), J(a_slot), J(b_slot), J(c_slot), J(flags), nprod=nprod,
        nc=NRUNS, bs=bs, interpret=True, semiring=rs, seg_start=seg_start))
    _compare(port[visited], want_pallas[visited], exact)


def _operands(srname, bs, seed):
    """Integer-valued operands blockized by both packages."""
    rng = np.random.default_rng(seed)
    da = np.rint(2 * rng.standard_normal((37, 29))) * (rng.random((37, 29))
                                                       < 0.3)
    db = np.rint(2 * rng.standard_normal((29, 41))) * (rng.random((29, 41))
                                                       < 0.3)
    ra, rb_ = rsp.from_dense(da), rsp.from_dense(db)
    zero = rsr.by_name(srname).zero
    ta = tbs.from_csc(csc_from_arrays(ra.shape, ra.indptr, ra.indices,
                                      ra.data), bs=bs, fill=zero)
    tb = tbs.from_csc(csc_from_arrays(rb_.shape, rb_.indptr, rb_.indices,
                                      rb_.data), bs=bs, fill=zero)
    return ra, rb_, ta, tb, rbs.from_csc(ra, bs=bs, fill=zero), \
        rbs.from_csc(rb_, bs=bs, fill=zero)


@pytest.mark.parametrize("bs", [1, 16, 32])
@pytest.mark.parametrize("srname", SEMIRINGS)
def test_local_spgemm_device_matches_reference(srname, bs):
    ra, rb_, ta, tb, rab, rbb = _operands(srname, bs, seed=bs)
    ts, rs = tsr.by_name(srname), rsr.by_name(srname)
    got = local_spgemm_device(ta, tb, device="cpu", semiring=ts)
    want = r_local_spgemm_device(rab, rbb, use_kernel=False, semiring=rs)
    np.testing.assert_array_equal(got.tiles, want.tiles)
    np.testing.assert_array_equal(got.tile_rows, want.tile_rows)
    np.testing.assert_array_equal(got.tile_cols, want.tile_cols)
    c = got.to_csc(semiring=ts)
    orc = rls.spgemm(ra, rb_, rs)
    if srname == "plus_times":
        orc = orc.prune(0.0)
    np.testing.assert_array_equal(c.indptr, orc.indptr)
    np.testing.assert_array_equal(c.indices, orc.indices)
    np.testing.assert_array_equal(c.data, orc.data.astype(np.float32))


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_local_spgemm_device_empty_product(srname):
    ts = tsr.by_name(srname)
    a = blocksparse_from_arrays(np.full((1, 4, 4), ts.zero, np.float32),
                                [0], [0], (8, 8), (8, 8), 4, ts.zero)
    b = blocksparse_from_arrays(np.full((1, 4, 4), ts.zero, np.float32),
                                [1], [0], (8, 8), (8, 8), 4, ts.zero)
    c = local_spgemm_device(a, b, device="cpu", semiring=ts)
    assert c.ntiles == 0 and c.fill == ts.zero
    assert c.to_csc(semiring=ts).nnz == 0


def test_fill_mismatch_rejected():
    """0.0-filled payloads under min-plus would act as zero-cost edges;
    both packages refuse them with the same message."""
    ra, rb_, ta, tb, rab, rbb = _operands("plus_times", 16, seed=3)
    with pytest.raises(ValueError, match="filled with 0.0") as got:
        local_spgemm_device(ta, tb, device="cpu", semiring=tsr.MIN_PLUS)
    with pytest.raises(ValueError) as want:
        r_local_spgemm_device(rab, rbb, use_kernel=False,
                              semiring=rsr.MIN_PLUS)
    assert str(got.value) == str(want.value)


def test_local_spgemm_device_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, ta, tb, _, _ = _operands("plus_times", 16, seed=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_spgemm_device(ta, tb)


@pytest.mark.parametrize("window", [(0, 11), (3, 6), (4, 0), (10, 1)])
def test_run_starts_from_flags(window):
    c = np.array([0, 0, 1, 1, 1, 2, 4, 4, 5, 6, 6], dtype=np.int32)
    flags = tbs.flags_from_c_slot(c)
    seg_start, nprod = window
    got = tkernel.run_starts_from_flags(flags, seg_start, nprod)
    assert got.dtype == np.int32
    assert got[-1] == seg_start + nprod
    runs = np.split(np.arange(seg_start, seg_start + nprod),
                    got[1:-1] - seg_start)
    for run in runs:
        if len(run):
            assert len(set(c[run])) == 1  # one output slot per run
    # runs are maximal: neighbours differ in slot
    assert all(c[got[k] - 1] != c[got[k]] for k in range(1, len(got) - 1))


def _launch_args(bs=16, nprod=5, nc=3):
    a = torch.zeros(4, bs, bs)
    slots = torch.zeros(nprod, dtype=torch.int32)
    return dict(a_tiles=a, b_tiles=a.clone(), a_slot=slots, b_slot=slots,
                c_slot=slots, run_starts=torch.tensor([0, nprod],
                                                      dtype=torch.int32),
                out=torch.zeros(nc, bs, bs), nprod=nprod, nc=nc, bs=bs,
                semiring=tsr.PLUS_TIMES, seg_start=0)


@pytest.mark.parametrize("bad", ["bs1", "bs48", "float64", "strided",
                                 "misaligned", "short_slots", "int64_slots",
                                 "out_rows", "device"])
def test_kernel_argument_checks(bad):
    kw = _launch_args()
    tkernel.check_launch_args(**kw)  # the baseline is accepted
    if bad == "bs1":
        kw = _launch_args(bs=1)
    elif bad == "bs48":
        kw = _launch_args(bs=48)
    elif bad == "float64":
        kw["a_tiles"] = kw["a_tiles"].double()
    elif bad == "strided":
        kw["b_tiles"] = torch.zeros(4, 16, 32)[:, :, :16]
    elif bad == "misaligned":
        kw["a_tiles"] = torch.zeros(4 * 256 + 1)[1:].view(4, 16, 16)
    elif bad == "short_slots":
        kw["seg_start"] = 1
    elif bad == "int64_slots":
        kw["c_slot"] = kw["c_slot"].long()
    elif bad == "out_rows":
        kw["out"] = torch.zeros(5, 16, 16)
    elif bad == "device":
        kw["a_tiles"] = kw["a_tiles"].to("meta")
    with pytest.raises(ValueError):
        tkernel.check_launch_args(**kw)


def test_cpu_wrapper_never_counts_a_launch():
    before = tkernel.bsr_spgemm.launches
    kw = _launch_args()
    tkernel.bsr_spgemm(kw["a_tiles"], kw["b_tiles"], kw["a_slot"],
                       kw["b_slot"], kw["c_slot"], kw["run_starts"],
                       nprod=5, nc=3, bs=16)
    assert tkernel.bsr_spgemm.launches == before
