"""The port's 1D ring against the reference: same plans, same results.

* Plans: ``build_device_plan`` is host numpy in both packages, so every
  array, tuple and stat of the port's plan equals the reference planner's
  (exact; ``plan_seconds`` is a wall time and is only checked present).
* Results: the port's ring on the CPU (the plain version, and the kernel
  wrapper, which takes the plain version on CPU tensors) decodes bitwise
  to ``repro.core.spgemm_1d`` and ``repro.core.local_spgemm.spgemm`` on
  integer-valued operands, for all three semirings, with empty parts and
  dims that are not tile multiples; for P=1 also to the reference's
  ``run_device_spgemm(engine="jnp")``. The reference's multi-device Pallas
  path is not used.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _propcheck import strategies as st

import repro.core.local_spgemm as rls
import repro.core.semiring as rsr
import repro.core.sparse as rsp
from repro.core.device_common import REQUIRED_STATS as R_REQUIRED_STATS
from repro.core.plan import Partition1D as RPartition1D
from repro.core.plan import build_fetch_plan as r_build_fetch_plan
from repro.core.spgemm_1d import spgemm_1d as r_spgemm_1d
from repro.core.spgemm_1d_device import \
    build_device_plan as r_build_device_plan
from repro.core.spgemm_1d_device import \
    run_device_spgemm as r_run_device_spgemm
from repro_torch.core import semiring as tsr
from repro_torch.core.convert import csc_from_arrays, plan_from_reference
from repro_torch.core.device_common import REQUIRED_STATS
from repro_torch.core.plan import BYTES_PER_NNZ
from repro_torch.core.spgemm_1d_device import (build_device_plan,
                                               compile_ring,
                                               decode_ring_output,
                                               repack_ring_payloads,
                                               run_device_spgemm)
from repro_torch.kernels.bsr_spgemm import kernel as tkernel

SEMIRINGS = ("plus_times", "bool_or_and", "min_plus")


def _port(mat):
    return csc_from_arrays(mat.shape, mat.indptr, mat.indices, mat.data)


def _int_pair(seed):
    """Random integer-valued pair with dims that are not tile multiples
    (small dims leave ring parts empty)."""
    a, b, _, _ = st.int_matmul_pair().example(np.random.default_rng(seed))
    return a, b


def _banded(n=100, half=6, seed=7):
    r = np.random.default_rng(seed)
    dense = np.zeros((n, n))
    ii, jj = np.indices((n, n))
    band = np.abs(ii - jj) <= half
    dense[band] = np.rint(2 * r.standard_normal(band.sum()))
    return rsp.from_dense(dense)


def _oracle(a, b, nparts, srname):
    orc = r_spgemm_1d(a, b, nparts, semiring=rsr.by_name(srname)).concat()
    return orc.prune(0.0) if srname == "plus_times" else orc


def _assert_csc(c, ref, ctx):
    assert c.shape == ref.shape, ctx
    assert np.array_equal(c.indptr, ref.indptr), ctx
    assert np.array_equal(c.indices, ref.indices), ctx
    assert np.array_equal(c.data, ref.data.astype(np.float32)), ctx


def _assert_same_plan(tp, rp):
    for f in dataclasses.fields(rp):
        x, y = getattr(tp, f.name), getattr(rp, f.name)
        if f.name == "semiring":
            assert x.name == y.name
        elif f.name in ("part_k", "part_n"):
            assert np.array_equal(x.splits, y.splits), f.name
        elif f.name == "stats":
            assert set(x) == set(y)
            for k in y:
                if k != "plan_seconds":
                    assert x[k] == y[k], k
        elif isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


CHUNKS = [None, 1, 2, "P", "big"]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("nparts", [1, 2, 8])
def test_plan_arrays_equal_reference(nparts, chunk):
    chunk = {"P": nparts, "big": nparts + 5}.get(chunk, chunk)
    cases = [(_banded(), _banded(), 16, None, "min_plus"),
             (*_int_pair(nparts), 8, None, "plus_times"),
             (*_int_pair(nparts + 10), 4, 2, "bool_or_and")]
    for a, b, bs, nblocks, srname in cases:
        rp = r_build_device_plan(a, b, nparts=nparts, bs=bs, nblocks=nblocks,
                                 semiring=rsr.by_name(srname), chunk=chunk)
        tp = build_device_plan(_port(a), _port(b), nparts=nparts, bs=bs,
                               nblocks=nblocks,
                               semiring=tsr.by_name(srname), chunk=chunk)
        _assert_same_plan(tp, rp)
        assert REQUIRED_STATS == R_REQUIRED_STATS
        assert all(k in tp.stats for k in REQUIRED_STATS)
        assert tp.stats["plan_seconds"] >= 0


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_ring_matches_host_oracles(srname):
    """CPU ring vs spgemm_1d and the local oracle, bitwise, over random
    non-tile-multiple pairs (empty parts) and a banded input whose far ring
    steps carry nothing, unchunked and chunked. (The kernel engine's
    plumbing on the same path is pinned by the argument-check test
    below.)"""
    sr = tsr.by_name(srname)
    pairs = [(*_int_pair(100 + k), 4 + 4 * k) for k in range(2)]
    pairs.append((_banded(n=70), _banded(n=70), 16))
    for ci, (a, b, bs) in enumerate(pairs):
        local = rls.spgemm(a, b, rsr.by_name(srname))
        if srname == "plus_times":
            local = local.prune(0.0)
        for nparts in (2, 8):
            orc = _oracle(a, b, nparts, srname)
            _assert_csc(orc, local, "oracles agree")
            for chunk in (None, 1, 2, nparts + 5):
                plan = build_device_plan(_port(a), _port(b), nparts=nparts,
                                         bs=bs, semiring=sr, chunk=chunk)
                c = run_device_spgemm(plan, device="cpu")
                _assert_csc(c, orc, (ci, nparts, chunk))


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_single_part_matches_reference_jnp_engine(srname):
    a, b = _int_pair(11)
    for chunk in (None, 1):
        rp = r_build_device_plan(a, b, nparts=1, bs=8,
                                 semiring=rsr.by_name(srname), chunk=chunk)
        want = r_run_device_spgemm(rp, engine="jnp")
        tp = build_device_plan(_port(a), _port(b), nparts=1, bs=8,
                               semiring=tsr.by_name(srname), chunk=chunk)
        _assert_csc(run_device_spgemm(tp, device="cpu"), want, chunk)


@pytest.mark.parametrize("chunk", [None, 2])
@pytest.mark.parametrize("srname", SEMIRINGS)
def test_ring_runs_on_the_reference_plan(srname, chunk):
    """plan_from_reference carries the reference planner's own plan across;
    the port's ring on it decodes to the same CSC as on its own plan."""
    a, b = _int_pair(21)
    rp = r_build_device_plan(a, b, nparts=4, bs=8,
                             semiring=rsr.by_name(srname), chunk=chunk)
    carried = plan_from_reference(vars(rp))
    assert carried.semiring is tsr.by_name(srname)
    own = build_device_plan(_port(a), _port(b), nparts=4, bs=8,
                            semiring=tsr.by_name(srname), chunk=chunk)
    _assert_same_plan(carried, rp)
    _assert_csc(run_device_spgemm(carried, device="cpu"),
                run_device_spgemm(own, device="cpu"), chunk)
    with pytest.raises(ValueError, match="missing"):
        plan_from_reference({"nparts": 4})


def test_repack_matches_cold_plan():
    a, b = _int_pair(31)
    sr = tsr.MIN_PLUS
    plan = build_device_plan(_port(a), _port(b), nparts=4, bs=8, semiring=sr,
                             chunk=2)
    fn, args = compile_ring(plan, device="cpu")
    a3 = _port(a)
    a3.data = a3.data * 3
    new_a, new_b = repack_ring_payloads(plan, a3, None)
    assert new_b is None
    args[0] = torch.from_numpy(new_a)
    got = decode_ring_output(plan, fn(*args))
    cold = build_device_plan(a3, _port(b), nparts=4, bs=8, semiring=sr,
                             chunk=2)
    _assert_csc(got, run_device_spgemm(cold, device="cpu"), "repack")


def test_ring_comm_model_matches_fetch_plan():
    """At bs=1 a payload tile is one stored element, so the ring's planned
    tile count equals build_fetch_plan's fetched-nonzero count (the
    reference's cross-check, on the port's planner)."""
    from repro_torch.core.plan import Partition1D, build_fetch_plan

    a = _port(rsp.erdos_renyi(120, 120, 4.0, seed=2))
    b = _port(rsp.banded_clustered(120, 12, 5.0, seed=1))
    for nparts in (2, 4):
        pk = Partition1D.balanced(a.ncols, nparts)
        pn = Partition1D.balanced(b.ncols, nparts)
        for nblocks in (None, 3):
            plan = build_device_plan(a, b, nparts=nparts, bs=1,
                                     nblocks=nblocks)
            host_nb = a.ncols if nblocks is None else nblocks
            fp = build_fetch_plan(a, b, pk, pn, nblocks=host_nb)
            assert plan.stats["exact_tiles"] * BYTES_PER_NNZ \
                == fp.total_fetched_bytes, (nparts, nblocks)
            fp1 = build_fetch_plan(a, b, pk, pn, nblocks=1)
            assert plan.stats["messages"] == fp1.total_messages
            rfp = r_build_fetch_plan(
                rsp.erdos_renyi(120, 120, 4.0, seed=2),
                rsp.banded_clustered(120, 12, 5.0, seed=1),
                RPartition1D.balanced(120, nparts),
                RPartition1D.balanced(120, nparts), nblocks=host_nb)
            assert rfp.total_fetched_bytes == fp.total_fetched_bytes


@pytest.mark.parametrize("chunk", [None, 1, 2])
def test_ring_hands_the_kernel_arguments_it_accepts(monkeypatch, chunk):
    """Every launch the ring would make on a card passes the wrapper's
    checks (dtype, contiguity, alignment, bs, window bounds): the ring runs
    with engine="cuda" on CPU tensors and each call is checked first."""
    inner = tkernel.bsr_spgemm
    calls = []

    def checked(a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts, *,
                nprod, nc, bs, semiring, seg_start=0, out=None):
        if nprod:
            tkernel.check_launch_args(
                a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts,
                out if out is not None else torch.empty(nc, bs, bs),
                nprod=nprod, nc=nc, bs=bs, semiring=semiring,
                seg_start=seg_start)
            starts = run_starts.numpy()
            assert starts[0] >= seg_start
            assert starts[-1] <= seg_start + nprod
        calls.append(nprod)
        return inner(a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts,
                     nprod=nprod, nc=nc, bs=bs, semiring=semiring,
                     seg_start=seg_start, out=out)

    monkeypatch.setattr(tkernel, "bsr_spgemm", checked)
    a = _port(rsp.laplacian_2d(24).astype(np.float32))
    for srname in SEMIRINGS:
        plan = build_device_plan(a, a, nparts=8, bs=16, chunk=chunk,
                                 semiring=tsr.by_name(srname))
        c = run_device_spgemm(plan, device="cpu", engine="cuda")
        orc = _oracle(rsp.laplacian_2d(24).astype(np.float32),
                      rsp.laplacian_2d(24).astype(np.float32), 8, srname)
        _assert_csc(c, orc, (srname, chunk))
    assert calls and max(calls) > 0


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    plan = build_device_plan(_port(_banded()), _port(_banded()), nparts=2,
                             bs=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_device_spgemm(plan)
