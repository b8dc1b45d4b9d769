"""The port's 2D SUMMA and Split-3D against the reference: same plans, same
results.

* Plans: ``build_summa_plan`` is host numpy in both packages, so every array
  and stat of the port's plan equals the reference planner's (exact;
  ``plan_seconds`` is a wall time and is only checked present), for (grid,
  layers) in {(1, 1), (2, 1), (3, 1), (2, 2), (2, 3)} and all three
  semirings, on inputs with empty parts and dims that are not tile
  multiples.
* Results: the port's body on the CPU (the plain version, and the kernel
  wrapper, which takes the plain version on CPU tensors) decodes bitwise to
  ``repro.core.spgemm_2d`` / ``spgemm_3d`` and ``local_spgemm.spgemm`` on
  integer-valued operands, and within rtol 1e-5 (float32 payloads against
  the float64 oracle) on general floats; at grid 1 also to the reference's
  ``run_device_summa(engine="jnp")``. The reference's multi-device Pallas
  path is not used.
* The index remap that replaces the reference's ``all_gather`` addresses
  the same tiles as a gathered stack would; unvisited union slots come out
  as the identity before the layer merge; every launch the body makes
  passes the kernel wrapper's checks.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _propcheck import strategies as st

import repro.core.local_spgemm as rls
import repro.core.plan as rplan
import repro.core.semiring as rsr
import repro.core.sparse as rsp
from repro.core.spgemm_2d import spgemm_2d as r_spgemm_2d
from repro.core.spgemm_2d_device import build_summa_plan as r_build_summa_plan
from repro.core.spgemm_2d_device import \
    repack_summa_payloads as r_repack_summa_payloads
from repro.core.spgemm_2d_device import run_device_summa as r_run_device_summa
from repro.core.spgemm_3d import spgemm_3d as r_spgemm_3d
from repro_torch.core import semiring as tsr
from repro_torch.core.convert import csc_from_arrays, summa_plan_from_reference
from repro_torch.core.device_common import (REQUIRED_STATS, run_schedule,
                                            window_run_starts)
from repro_torch.core.spgemm_2d_device import (build_summa_plan,
                                               compile_summa,
                                               decode_summa_output,
                                               global_slots,
                                               repack_summa_payloads,
                                               run_device_summa)
from repro_torch.core.spgemm_3d_device import (build_summa3d_plan,
                                               run_device_summa3d)
from repro_torch.kernels.bsr_spgemm import kernel as tkernel

SEMIRINGS = ("plus_times", "bool_or_and", "min_plus")
GEOMETRIES = [(1, 1), (2, 1), (3, 1), (2, 2), (2, 3)]


def _port(mat):
    return csc_from_arrays(mat.shape, mat.indptr, mat.indices, mat.data)


def _int_pair(seed):
    """Random integer-valued pair with dims that are not tile multiples
    (small dims leave mesh parts and layers empty)."""
    a, b, _, _ = st.int_matmul_pair().example(np.random.default_rng(seed))
    return a, b


def _banded(n=100, half=6, seed=7):
    r = np.random.default_rng(seed)
    dense = np.zeros((n, n))
    ii, jj = np.indices((n, n))
    band = np.abs(ii - jj) <= half
    dense[band] = np.rint(2 * r.standard_normal(band.sum()))
    return rsp.from_dense(dense)


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
        elif f.name.startswith("part_"):
            assert np.array_equal(x.splits, y.splits), f.name
        elif f.name == "stats":
            assert set(x) == set(y)
            for k in y:
                if k == "plan_seconds":
                    continue
                if isinstance(y[k], np.ndarray):
                    assert np.array_equal(x[k], y[k]), k
                else:
                    assert x[k] == y[k], k
        elif isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _host_oracle(a, b, grid, layers, srname):
    sr = rsr.by_name(srname)
    if layers == 1:
        c = r_spgemm_2d(a, b, grid, sr).c
    else:
        c = r_spgemm_3d(a, b, grid, layers, sr).c
    return c.prune(0.0) if srname == "plus_times" else c


@pytest.mark.parametrize("srname", SEMIRINGS)
@pytest.mark.parametrize("grid,layers", GEOMETRIES)
def test_summa_plan_arrays_equal_reference(grid, layers, srname):
    sr_t, sr_r = tsr.by_name(srname), rsr.by_name(srname)
    cases = [(_banded(), _banded(), 16),
             (*_int_pair(grid * 10 + layers), 8),
             (*_int_pair(grid * 10 + layers + 100), 4)]
    for a, b, bs in cases:
        rp = r_build_summa_plan(a, b, grid, layers=layers, bs=bs,
                                semiring=sr_r)
        tp = build_summa_plan(_port(a), _port(b), grid, layers=layers,
                              bs=bs, semiring=sr_t)
        _assert_same_plan(tp, rp)
        assert all(k in tp.stats for k in REQUIRED_STATS)
        assert tp.stats["plan_seconds"] >= 0
        assert tp.exact_bytes == tp.stats["comm_bytes_planned"] \
            <= tp.stats["comm_bytes_padded"] == tp.padded_bytes
        if grid == 1:
            assert tp.stats["comm_bytes_planned"] == 0 or layers > 1


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_summa_matches_host_oracles(srname):
    """CPU body vs spgemm_2d / spgemm_3d and the local oracle, bitwise, on
    random non-tile-multiple pairs (empty parts, empty layers) and a banded
    input, through the plain version and through the kernel wrapper."""
    sr = tsr.by_name(srname)
    pairs = [(*_int_pair(300 + k), 4 + 4 * k) for k in range(2)]
    pairs.append((_banded(n=70), _banded(n=70), 16))
    for ci, (a, b, bs) in enumerate(pairs):
        local = rls.spgemm(a, b, rsr.by_name(srname))
        if srname == "plus_times":
            local = local.prune(0.0)
        for grid, layers in GEOMETRIES:
            orc = _host_oracle(a, b, grid, layers, srname)
            _assert_csc(orc, local, "oracles agree")
            plan = build_summa_plan(_port(a), _port(b), grid, layers=layers,
                                    bs=bs, semiring=sr)
            for engine in ("torch", "cuda"):
                c = run_device_summa(plan, device="cpu", engine=engine)
                _assert_csc(c, orc, (ci, grid, layers, engine))


@pytest.mark.parametrize("grid,layers", [(2, 1), (2, 2), (3, 1)])
def test_summa_float_values_within_tolerance(grid, layers):
    """General floats: float32 payloads against the float64 host oracle,
    within rtol 1e-5 (float32 rounding, summation order)."""
    a = rsp.erdos_renyi(90, 70, 4.0, seed=1)
    b = rsp.banded_clustered(70, 10, 5.0, seed=2)
    want = r_spgemm_3d(a, b, grid, layers).c.to_dense()
    plan = build_summa3d_plan(_port(a), _port(b), grid, layers, bs=16)
    got = run_device_summa3d(plan, device="cpu").to_dense()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_single_grid_matches_reference_jnp_engine(srname):
    a, b = _int_pair(11)
    rp = r_build_summa_plan(a, b, 1, bs=8, semiring=rsr.by_name(srname))
    want = r_run_device_summa(rp, engine="jnp")
    tp = build_summa_plan(_port(a), _port(b), 1, bs=8,
                          semiring=tsr.by_name(srname))
    _assert_csc(run_device_summa(tp, device="cpu"), want, srname)


@pytest.mark.parametrize("grid,layers", [(2, 1), (2, 2)])
@pytest.mark.parametrize("srname", SEMIRINGS)
def test_summa_runs_on_the_reference_plan(srname, grid, layers):
    """summa_plan_from_reference carries the reference planner's own plan
    across; the port's body on it decodes to the same CSC as on its own
    plan."""
    a, b = _int_pair(21)
    rp = r_build_summa_plan(a, b, grid, layers=layers, bs=8,
                            semiring=rsr.by_name(srname))
    carried = summa_plan_from_reference(vars(rp))
    assert carried.semiring is tsr.by_name(srname)
    own = build_summa_plan(_port(a), _port(b), grid, layers=layers, bs=8,
                           semiring=tsr.by_name(srname))
    _assert_same_plan(carried, rp)
    _assert_csc(run_device_summa(carried, device="cpu"),
                run_device_summa(own, device="cpu"), (grid, layers))
    with pytest.raises(ValueError, match="missing"):
        summa_plan_from_reference({"grid": 2})


@pytest.mark.parametrize("grid,layers", [(2, 1), (2, 2)])
def test_summa_repack_matches_cold_plan(grid, layers):
    a, b = _int_pair(31)
    sr = tsr.MIN_PLUS
    plan = build_summa_plan(_port(a), _port(b), grid, layers=layers, bs=8,
                            semiring=sr)
    fn, args = compile_summa(plan, device="cpu")
    a3 = _port(a)
    a3.data = a3.data * 3
    new_a, new_b = repack_summa_payloads(plan, a3, None)
    assert new_b is None
    ra3 = rsp.CSC(a.indptr, a.indices, a.data * 3, a.shape)
    want_a, _ = r_repack_summa_payloads(
        r_build_summa_plan(a, b, grid, layers=layers, bs=8,
                           semiring=rsr.MIN_PLUS), ra3, None)
    assert new_a.dtype == want_a.dtype and np.array_equal(new_a, want_a)
    args[0] = torch.from_numpy(new_a).reshape(args[0].shape)
    got = decode_summa_output(plan, fn(*args))
    cold = build_summa_plan(a3, _port(b), grid, layers=layers, bs=8,
                            semiring=sr)
    assert np.array_equal(cold.a_tiles, new_a)
    _assert_csc(got, run_device_summa(cold, device="cpu"), "repack")


def test_summa_comm_model_matches_host_models():
    """The device plan's element-level gather model equals the host models:
    ``summa2d_comm_volume`` on the plan's own tile-snapped partitions (2D),
    the sum of per-layer 2D models (3D), and at bs=1 with dims the mesh
    divides — where the plan's partitions are the host models' balanced
    cuts — ``summa2d_comm_volume``'s and ``summa3d_comm_volume``'s own
    totals (the latter without its layer-merge term)."""
    a = rsp.erdos_renyi(120, 120, 4.0, seed=2)
    for grid, bs in ((2, 32), (3, 16)):
        plan = build_summa_plan(_port(a), _port(a), grid, bs=bs)
        vol = rplan.summa2d_comm_volume(a, a, grid,
                                        row_splits=plan.part_m.splits,
                                        colk_splits=plan.part_k.splits,
                                        coln_splits=plan.part_n.splits)
        assert plan.stats["comm_bytes_model"] == vol["total_bytes"]
        np.testing.assert_array_equal(
            plan.stats["comm_bytes_model_per_device"],
            vol["per_process_bytes"])
    for grid, layers, bs in ((2, 2, 32), (2, 3, 16)):
        plan = build_summa3d_plan(_port(a), _port(a), grid, layers, bs=bs)
        ks = plan.part_k.splits
        total, per_proc = 0, np.zeros(grid * grid, dtype=np.int64)
        for l in range(layers):
            klo, khi = int(ks[l * grid]), int(ks[(l + 1) * grid])
            a_l = a.col_slice(klo, khi)
            b_l = a.transpose().col_slice(klo, khi).transpose()
            vol = rplan.summa2d_comm_volume(
                a_l, b_l, grid, row_splits=plan.part_m.splits,
                colk_splits=ks[l * grid:(l + 1) * grid + 1] - klo,
                coln_splits=plan.part_n.splits)
            total += vol["total_bytes"]
            per_proc += vol["per_process_bytes"]
        assert plan.stats["comm_bytes_model"] == total, (grid, layers)
        np.testing.assert_array_equal(
            plan.stats["comm_bytes_model_per_device"], per_proc)
    # bs=1, 120 divisible by every grid * layers below
    for grid, layers in ((2, 1), (3, 1), (2, 2), (2, 3)):
        plan = build_summa3d_plan(_port(a), _port(a), grid, layers, bs=1)
        if layers == 1:
            want = rplan.summa2d_comm_volume(a, a, grid)["total_bytes"]
        else:
            want = rplan.summa3d_comm_volume(a, a, grid, layers)["bytes_ab"]
        assert plan.stats["comm_bytes_model"] == want, (grid, layers)


@pytest.mark.parametrize("grid,layers", [(2, 1), (2, 3)])
def test_global_slots_address_the_gathered_stacks(grid, layers):
    """The index remap that replaces the reference's all_gather: each
    part's global A / B slots pick from the flat stacks exactly the tiles
    its stage-ordered gathered stack holds at its plan slots."""
    a, b = _int_pair(41)
    plan = build_summa_plan(_port(a), _port(b), grid, layers=layers, bs=4)
    a_glob, b_glob = global_slots(plan)
    bs = plan.bs
    a_flat = plan.a_tiles.reshape(-1, bs, bs)
    b_flat = plan.b_tiles.reshape(-1, bs, bs)
    for r in range(grid):
        for c in range(grid):
            for l in range(layers):
                d = (r * grid + c) * layers + l
                gath_a = plan.a_tiles[r, :, l].reshape(-1, bs, bs)
                gath_b = plan.b_tiles[:, c, l].reshape(-1, bs, bs)
                assert np.array_equal(a_flat[a_glob[d]],
                                      gath_a[plan.a_slot[r, c, l]])
                assert np.array_equal(b_flat[b_glob[d]],
                                      gath_b[plan.b_slot[r, c, l]])


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("srname", SEMIRINGS)
def test_unvisited_union_slots_are_the_identity(srname, engine):
    """Before the layer merge, each layer's partial holds the semiring's
    identity in every union slot its schedule does not visit (the plan's
    ``visit`` mask), so the reference's reset is implied: the layers reduce
    as they come out."""
    sr = tsr.by_name(srname)
    a, b = _banded(n=90, half=5), _banded(n=90, half=5, seed=3)
    plan = build_summa3d_plan(_port(a), _port(b), 2, 3, bs=8, semiring=sr)
    fn, args = compile_summa(plan, device="cpu", engine=engine)
    a_flat, b_flat, a_glob, b_glob, c_slot = args
    visit = plan.visit.reshape(-1, plan.nc_max + 1)
    nprod = a_glob.shape[1]
    flags = plan.flags.reshape(-1, nprod)
    unvisited = 0
    for d in range(a_glob.shape[0]):
        starts = torch.from_numpy(window_run_starts(
            flags[d], c_slot[d].numpy(), plan.nc_max, 0, nprod))
        out = torch.full((plan.nc_max + 1, plan.bs, plan.bs), float("nan"))
        run_schedule(a_flat, b_flat, a_glob[d], b_glob[d], c_slot[d],
                     starts, engine=engine, nprod_max=nprod,
                     nc_max=plan.nc_max, bs=plan.bs, semiring=sr, out=out)
        idle = ~torch.from_numpy(visit[d])
        unvisited += int(idle.sum())
        assert torch.all(out[idle] == sr.zero), d
    assert unvisited > 0, "the case should leave union slots unvisited"


@pytest.mark.parametrize("grid,layers", [(2, 1), (2, 2), (3, 1)])
def test_summa_hands_the_kernel_arguments_it_accepts(monkeypatch, grid,
                                                     layers):
    """Every launch the SUMMA body would make on a card passes the
    wrapper's checks (dtype, contiguity, alignment, bs, window bounds): the
    body runs with engine="cuda" on CPU tensors and each call is checked
    first; the A / B stacks it hands over are the flat resident stacks."""
    inner = tkernel.bsr_spgemm
    calls = []

    def checked(a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts, *,
                nprod, nc, bs, semiring, seg_start=0, out=None):
        tkernel.check_launch_args(
            a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts,
            out if out is not None else torch.empty(nc, bs, bs),
            nprod=nprod, nc=nc, bs=bs, semiring=semiring,
            seg_start=seg_start)
        starts = run_starts.numpy()
        assert seg_start <= starts[0] and starts[-1] <= seg_start + nprod
        assert int(a_slot.max()) < a_tiles.shape[0]
        assert int(b_slot.max()) < b_tiles.shape[0]
        calls.append((a_tiles.data_ptr(), b_tiles.data_ptr()))
        return inner(a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts,
                     nprod=nprod, nc=nc, bs=bs, semiring=semiring,
                     seg_start=seg_start, out=out)

    monkeypatch.setattr(tkernel, "bsr_spgemm", checked)
    lap = rsp.laplacian_2d(24).astype(np.float32)
    for srname in SEMIRINGS:
        plan = build_summa_plan(_port(lap), _port(lap), grid, layers=layers,
                                bs=16, semiring=tsr.by_name(srname))
        before = len(calls)
        c = run_device_summa(plan, device="cpu", engine="cuda")
        _assert_csc(c, _host_oracle(lap, lap, grid, layers, srname),
                    (srname, grid, layers))
        assert len(calls) - before == grid * grid * layers
        assert len(set(calls[before:])) == 1    # one pair of flat stacks


def test_summa_plan_rejects_mismatched_semiring():
    plan = build_summa_plan(_port(_banded()), _port(_banded()), 1, bs=16)
    with pytest.raises(ValueError, match="rebuild the plan"):
        compile_summa(plan, device="cpu", semiring=tsr.MIN_PLUS)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    plan = build_summa_plan(_port(_banded()), _port(_banded()), 2, bs=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_device_summa(plan)
