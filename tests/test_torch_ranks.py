"""The port's three algorithms across processes, one part per rank, on the
CPU over gloo: the same results as the JAX package's host oracles and as
the port's one-process path.

The parent (this module) makes the inputs with numpy, computes the
oracles — ``repro.core.spgemm_1d`` and ``repro.core.local_spgemm.spgemm``
— and the port's one-process results, then spawns 2, 4 and 8 ranks with
``torch.multiprocessing`` and a ``file://`` init. The ranks run
``tests/_torch_ranks_worker.py``, which imports no ``jax``. Each world runs
its whole grid of cases in one spawn (a module-scoped fixture), and the
tests below read its results:

* the 1D ring at P = 2 and 4, ``chunk`` None and 2; 2D SUMMA at grid 2 and
  Split-3D at 2×2×2; each in all three semirings on integer-valued inputs
  with empty parts and dims that are not tile multiples — bitwise against
  the oracles and the one-process path, the same CSC on every rank; on
  general floats within rtol 1e-5 of the float64 oracle;
* min-plus Split-3D with a NaN whose layer partial sits on a rank other
  than 0 (a bare gloo ``all_reduce(MIN)`` merge loses it);
* the transport's bytes, summed over ranks: ``comm_bytes_padded`` for the
  ring, the plan's gather share ``D·(grid−1)·(max_na+max_nb)`` tiles for
  SUMMA;
* ``SpGEMMSession(group=...)``: cold, hit (no rebuild), repack, each rank's
  stats and ``last_call`` equal to the one-process session's; mismatched
  operands, a geometry larger than the world, a fault on one rank's execute
  (a retry on every rank) and a 3d→2d downgrade (the idle ranks get the
  result).

A hang cannot outlast the group's timeout (``GROUP_TIMEOUT_S`` in the
worker) or the parent's join limit: every spawn is killed past
:data:`SPAWN_LIMIT_S`.
"""

import dataclasses
import functools
import os
import queue
import tempfile
import time

import numpy as np
import pytest
import torch.multiprocessing as mp
from _propcheck import strategies as st

import _torch_ranks_worker as worker
import repro.core.local_spgemm as rls
import repro.core.semiring as rsr
import repro.core.sparse as rsp
from repro.core.spgemm_1d import spgemm_1d as r_spgemm_1d
from repro_torch.core import semiring as tsr
from repro_torch.core.convert import csc_from_arrays
from repro_torch.core.device_common import device_grid_mesh
from repro_torch.core.session import SpGEMMSession
from repro_torch.core.spgemm_1d_device import (build_device_plan,
                                               repack_ring_payloads,
                                               run_device_spgemm)
from repro_torch.core.spgemm_2d_device import (build_summa_plan,
                                               repack_summa_payloads,
                                               run_device_summa)
from repro_torch.core.validate import ValidationError
from repro_torch.runtime.fault_tolerance import RetryPolicy
from repro_torch.runtime.faults import FaultInjector

SEMIRINGS = ("plus_times", "bool_or_and", "min_plus")
SPAWN_LIMIT_S = 150

# ---------------------------------------------------------------------------
# inputs and oracles (parent side)
# ---------------------------------------------------------------------------


def _int_pair(seed):
    """Integer-valued pair with dims that are not tile multiples (small
    dims leave parts and layers empty)."""
    a, b, _, _ = st.int_matmul_pair().example(np.random.default_rng(seed))
    return a, b


def _banded(n=70, half=6, seed=7, floats=False):
    r = np.random.default_rng(seed)
    dense = np.zeros((n, n))
    ii, jj = np.indices((n, n))
    band = np.abs(ii - jj) <= half
    vals = r.standard_normal(band.sum())
    dense[band] = vals if floats else np.rint(2 * vals)
    return rsp.from_dense(dense)


# integer-valued (bitwise) inputs: (a, b, bs)
INT_CASES = [(*_int_pair(3), 8), (_banded(), _banded(seed=8), 16)]
FLOAT_CASE = (_banded(floats=True), _banded(seed=9, floats=True), 16)


def _arrays(m):
    return (tuple(m.shape), m.indptr, m.indices, m.data)


def _port(m):
    return csc_from_arrays(m.shape, m.indptr, m.indices, m.data)


def _ref(arrs):
    """The JAX package's CSC of a case's operand arrays."""
    shape, indptr, indices, data = arrs
    return rsp.CSC(indptr, indices, data, tuple(shape))


def _local(a, b, srname):
    c = rls.spgemm(a, b, rsr.by_name(srname))
    return c.prune(0.0) if srname == "plus_times" else c


def _ring_oracle(a, b, nparts, srname):
    c = r_spgemm_1d(a, b, nparts, semiring=rsr.by_name(srname)).concat()
    return c.prune(0.0) if srname == "plus_times" else c


def _same(c, ref, ctx):
    """Bitwise CSC equality, a NaN matching a NaN (``c`` as the worker's
    arrays)."""
    shape, indptr, indices, data = c
    assert tuple(shape) == tuple(ref.shape), ctx
    assert np.array_equal(indptr, ref.indptr), ctx
    assert np.array_equal(indices, ref.indices), ctx
    want = np.asarray(ref.data).astype(np.float32)
    assert np.array_equal(data, want, equal_nan=True), ctx


def _close(c, ref, ctx):
    shape, indptr, indices, data = c
    assert tuple(shape) == tuple(ref.shape), ctx
    assert np.array_equal(indptr, ref.indptr), ctx
    assert np.array_equal(indices, ref.indices), ctx
    np.testing.assert_allclose(data, ref.data, rtol=1e-5, atol=1e-5,
                               err_msg=str(ctx))


def _nan_case():
    """Min-plus operands for Split-3D at 2×2×2, bs 16, with a NaN in A at a
    contraction index of layer 1: the NaN reaches C only through the
    partials of layer-1 ranks (odd flat mesh indices, never rank 0), in
    entries whose layer-0 partial is finite."""
    a, b = _banded(seed=11), _banded(seed=12)
    a = rsp.CSC(a.indptr, a.indices, np.abs(a.data), a.shape)
    b = rsp.CSC(b.indptr, b.indices, np.abs(b.data), b.shape)
    plan = build_summa_plan(_port(a), _port(b), grid=2, layers=2, bs=16,
                            semiring=tsr.MIN_PLUS)
    # layer 1's first contraction index: its rows also meet layer 0's,
    # so the entries the NaN reaches have finite layer-0 partials
    col = plan.part_k.splits[2]
    data = a.data.copy()
    data[a.indptr[col]] = np.nan
    return rsp.CSC(a.indptr, a.indices, data, a.shape), b


# ---------------------------------------------------------------------------
# the grids, one spawn per world
# ---------------------------------------------------------------------------

def _ring_cases(nparts):
    cases = []
    for srname in SEMIRINGS:
        for chunk in (None, 2):
            for a, b, bs in INT_CASES:
                cases.append(dict(kind="ring", a=_arrays(a), b=_arrays(b),
                                  nparts=nparts, bs=bs, chunk=chunk,
                                  semiring=srname))
    for chunk in (None, 2):
        a, b, bs = FLOAT_CASE
        cases.append(dict(kind="ring", a=_arrays(a), b=_arrays(b),
                          nparts=nparts, bs=bs, chunk=chunk,
                          semiring="plus_times", floats=True))
    return cases


def _summa_cases(layers):
    cases = []
    for srname in SEMIRINGS:
        for a, b, bs in INT_CASES:
            cases.append(dict(kind="summa", a=_arrays(a), b=_arrays(b),
                              grid=2, layers=layers, bs=bs, semiring=srname))
    a, b, bs = FLOAT_CASE
    cases.append(dict(kind="summa", a=_arrays(a), b=_arrays(b), grid=2,
                      layers=layers, bs=bs, semiring="plus_times",
                      floats=True))
    return cases


def _twice(m):
    return rsp.CSC(m.indptr, m.indices, 2 * m.data, m.shape)


def _f32(m):
    return rsp.CSC(m.indptr, m.indices, m.data.astype(np.float32), m.shape)


def _session_calls(**geo):
    """Cold, hit and a values-only repack of one multiply (float32 operands:
    the session refuses to narrow a repack's values)."""
    a, b, bs = INT_CASES[1]
    a, b = _f32(a), _f32(b)
    kw = dict(bs=bs, semiring="min_plus", **geo)
    return [dict(a=_arrays(a), b=_arrays(b), **kw),
            dict(a=_arrays(a), b=_arrays(b), **kw),
            dict(a=_arrays(_twice(a)), b=_arrays(b), **kw)]


def _downgrade_case():
    a, b, bs = INT_CASES[0]
    return dict(kind="session",
                calls=[dict(a=_arrays(a), b=_arrays(b), algorithm="3d",
                            grid=2, layers=2, bs=bs)],
                faults={5: dict(rates={"execute": 1.0}, max_faults=3)})


SESSION_4 = {
    "cached_1d": dict(kind="session",
                      calls=_session_calls(algorithm="1d", nparts=4,
                                           chunk=2)),
    "too_large": dict(kind="session",
                      calls=[dict(a=_arrays(INT_CASES[0][0]),
                                  b=_arrays(INT_CASES[0][1]), nparts=8,
                                  bs=8)]),
    "launch_retry": dict(kind="session",
                         calls=[dict(a=_arrays(INT_CASES[1][0]),
                                     b=_arrays(INT_CASES[1][1]), nparts=4,
                                     bs=16, chunk=1)],
                         launch_faults={2: 1}),
    "fault_retry": dict(kind="session",
                        calls=[dict(a=_arrays(INT_CASES[1][0]),
                                    b=_arrays(INT_CASES[1][1]), nparts=4,
                                    bs=16)],
                        faults={1: dict(rates={"execute": 1.0},
                                        max_faults=1)}),
}
SESSION_8 = {
    "cached_2d": dict(kind="session",
                      calls=_session_calls(algorithm="2d", grid=2)),
    "cached_3d": dict(kind="session",
                      calls=_session_calls(algorithm="3d", grid=2,
                                           layers=2)),
    "mismatch": dict(kind="session",
                     calls=[dict(a=_arrays(INT_CASES[1][0]),
                                 b=_arrays(INT_CASES[1][1]), nparts=8,
                                 bs=16,
                                 b_on={3: _arrays(_twice(INT_CASES[1][1]))}),
                            dict(a=_arrays(INT_CASES[1][0]),
                                 b=_arrays(INT_CASES[1][1]), nparts=8,
                                 bs=16)]),
    "downgrade": _downgrade_case(),
}


def _piece_cases(world):
    """Min-plus through the ring (P = 4, chunked) or Split-3D (2×2×2) with
    transfers and the merge cut into pieces of one and three tiles."""
    a, b, bs = INT_CASES[1]
    tile = bs * bs * 4
    geo = (dict(kind="ring", nparts=4, chunk=2) if world == 4 else
           dict(kind="summa", grid=2, layers=2))
    return {("pieces", n): dict(a=_arrays(a), b=_arrays(b), bs=bs,
                                semiring="min_plus", piece_bytes=n * tile,
                                **geo)
            for n in (1, 3)}


def _grid(world):
    """Every case a world runs, keyed by name."""
    cases = {}
    if world == 2:
        cases["mesh_too_large"] = dict(kind="mesh", shape=(2, 2, 1))
        cases["mesh_of_two"] = dict(kind="mesh", shape=(1, 2, 1))
    if world in (4, 8):
        cases.update(_piece_cases(world))
    if world in (2, 4):
        cases.update({("ring", i): c
                      for i, c in enumerate(_ring_cases(world))})
    if world == 4:
        cases.update({("summa", i): c
                      for i, c in enumerate(_summa_cases(1))})
        cases.update(SESSION_4)
    if world == 8:
        cases.update({("summa", i): c
                      for i, c in enumerate(_summa_cases(2))})
        a, b = _nan_case()
        cases["nan"] = dict(kind="summa", a=_arrays(a), b=_arrays(b),
                            grid=2, layers=2, bs=16, semiring="min_plus")
        cases.update(SESSION_8)
    return cases


def _spawn(world, cases):
    """Run ``cases`` on ``world`` gloo ranks; returns per-rank results.
    Every process is joined, or killed past SPAWN_LIMIT_S."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        procs = [ctx.Process(target=worker.main,
                             args=(r, world, init, cases, q), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + SPAWN_LIMIT_S
        try:
            while len(got) < world and time.monotonic() < deadline:
                try:
                    rank, status, payload = q.get(timeout=1.0)
                except queue.Empty:
                    if all(p.exitcode is not None for p in procs):
                        break
                    continue
                got[rank] = (status, payload)
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    assert len(got) == world, (f"{world - len(got)} rank(s) reported "
                               f"nothing within {SPAWN_LIMIT_S} s")
    errors = {r: p for r, (s, p) in got.items() if s != "ok"}
    assert not errors, "\n".join(f"rank {r}:\n{p}" for r, p in errors.items())
    assert all(not p.is_alive() for p in procs)
    return [got[r][1] for r in range(world)]


@functools.lru_cache(maxsize=None)
def _run(world):
    cases = _grid(world)
    per_rank = _spawn(world, list(cases.values()))
    return {k: [res[i] for res in per_rank] for i, k in enumerate(cases)}


@pytest.fixture(scope="module")
def ranks():
    return _run


# ---------------------------------------------------------------------------
# ring and SUMMA across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("srname", SEMIRINGS)
@pytest.mark.parametrize("chunk", [None, 2])
@pytest.mark.parametrize("nparts", [2, 4])
def test_ring_across_ranks_matches_oracles(ranks, nparts, chunk, srname):
    res = ranks(nparts)
    for i, case in enumerate(_ring_cases(nparts)):
        if case["semiring"] != srname or case["chunk"] != chunk \
                or case.get("floats"):
            continue
        ra, rb = _ref(case["a"]), _ref(case["b"])
        orc = _ring_oracle(ra, rb, nparts, srname)
        local = _local(ra, rb, srname)
        plan = build_device_plan(_port(ra), _port(rb), nparts=nparts,
                                 bs=case["bs"],
                                 semiring=tsr.by_name(srname), chunk=chunk)
        one = run_device_spgemm(plan, device="cpu")
        for rank, r in enumerate(res[("ring", i)]):
            ctx = (nparts, chunk, srname, i, rank)
            _same(r["c"], orc, ctx)
            _same(r["c"], local, ctx)
            _same(r["c"], one, ctx)


@pytest.mark.parametrize("chunk", [None, 2])
@pytest.mark.parametrize("nparts", [2, 4])
def test_ring_across_ranks_on_floats(ranks, nparts, chunk):
    res = ranks(nparts)
    a, b, bs = FLOAT_CASE
    want = _local(a, b, "plus_times")
    one = run_device_spgemm(build_device_plan(_port(a), _port(b), nparts,
                                              bs=bs, chunk=chunk),
                            device="cpu")
    for i, case in enumerate(_ring_cases(nparts)):
        if case.get("floats") and case["chunk"] == chunk:
            for r in res[("ring", i)]:
                _close(r["c"], want, (nparts, chunk))
                _same(r["c"], one, (nparts, chunk))


@pytest.mark.parametrize("nparts", [2, 4])
def test_ring_transport_moves_the_padded_bytes(ranks, nparts):
    res = ranks(nparts)
    for i, case in enumerate(_ring_cases(nparts)):
        plan = build_device_plan(worker.as_csc(case["a"]),
                                 worker.as_csc(case["b"]), nparts,
                                 bs=case["bs"],
                                 semiring=tsr.by_name(case["semiring"]),
                                 chunk=case["chunk"])
        per = res[("ring", i)]
        for side in ("sent", "received"):
            assert sum(r["bytes"][side]["ring"] for r in per) == \
                plan.stats["comm_bytes_padded"], (i, side)
        assert all(r["bytes"]["received"]["gather"] == 0 for r in per)


def _summa_grid(world):
    layers = 1 if world == 4 else 2
    return layers, _summa_cases(layers)


@pytest.mark.parametrize("srname", SEMIRINGS)
@pytest.mark.parametrize("world", [4, 8], ids=["2d-grid2", "3d-2x2x2"])
def test_summa_across_ranks_matches_oracles(ranks, world, srname):
    res = ranks(world)
    layers, cases = _summa_grid(world)
    for i, case in enumerate(cases):
        if case["semiring"] != srname or case.get("floats"):
            continue
        ra, rb = _ref(case["a"]), _ref(case["b"])
        local = _local(ra, rb, srname)
        plan = build_summa_plan(_port(ra), _port(rb), grid=2, layers=layers,
                                bs=case["bs"], semiring=tsr.by_name(srname))
        one = run_device_summa(plan, device="cpu")
        for rank, r in enumerate(res[("summa", i)]):
            ctx = (world, srname, i, rank)
            _same(r["c"], local, ctx)
            _same(r["c"], one, ctx)


@pytest.mark.parametrize("world", [4, 8], ids=["2d-grid2", "3d-2x2x2"])
def test_summa_across_ranks_on_floats(ranks, world):
    res = ranks(world)
    layers, cases = _summa_grid(world)
    a, b, bs = FLOAT_CASE
    want = _local(a, b, "plus_times")
    one = run_device_summa(build_summa_plan(_port(a), _port(b), grid=2,
                                            layers=layers, bs=bs),
                           device="cpu")
    i = next(i for i, c in enumerate(cases) if c.get("floats"))
    for r in res[("summa", i)]:
        _close(r["c"], want, world)
        _same(r["c"], one, world)


@pytest.mark.parametrize("world", [4, 8], ids=["2d-grid2", "3d-2x2x2"])
def test_summa_transport_moves_the_gather_share(ranks, world):
    res = ranks(world)
    layers, cases = _summa_grid(world)
    for i, case in enumerate(cases):
        plan = build_summa_plan(worker.as_csc(case["a"]),
                                worker.as_csc(case["b"]), grid=2,
                                layers=layers, bs=case["bs"],
                                semiring=tsr.by_name(case["semiring"]))
        D, g = 2 * 2 * layers, 2
        tile = plan.bs * plan.bs * 4
        share = D * (g - 1) * (plan.a_tiles.shape[3]
                               + plan.b_tiles.shape[3]) * tile
        per = res[("summa", i)]
        for side in ("sent", "received"):
            assert sum(r["bytes"][side]["gather"] for r in per) == share
        # the layer merge gathers every layer's partial (garbage slot
        # dropped) on every rank of its (r, c) line
        merge = D * (layers - 1) * plan.nc_max * tile
        assert sum(r["bytes"]["received"]["merge"] for r in per) == merge


@pytest.mark.parametrize("world", [4, 8], ids=["ring-P4", "3d-2x2x2"])
def test_transfers_in_pieces_match_whole_ones(ranks, world):
    """Transfers cut into pieces of one or three tiles (and the Split-3D
    merge reduced piece by piece) give the one-process result bitwise
    and move the same bytes."""
    res = ranks(world)
    for key, case in _piece_cases(world).items():
        a, b = _port(_ref(case["a"])), _port(_ref(case["b"]))
        if case["kind"] == "ring":
            plan = build_device_plan(a, b, nparts=4, bs=case["bs"],
                                     semiring=tsr.MIN_PLUS, chunk=2)
            one = run_device_spgemm(plan, device="cpu")
            moved = {"ring": plan.stats["comm_bytes_padded"]}
        else:
            plan = build_summa_plan(a, b, grid=2, layers=2, bs=case["bs"],
                                    semiring=tsr.MIN_PLUS)
            one = run_device_summa(plan, device="cpu")
            tile = plan.bs * plan.bs * 4
            moved = {"merge": 8 * plan.nc_max * tile}
        per = res[key]
        for rank, r in enumerate(per):
            _same(r["c"], one, (key, rank))
        for kind, n in moved.items():
            assert sum(r["bytes"]["received"][kind] for r in per) == n


def test_split3d_merge_keeps_a_nan_off_rank_0(ranks):
    """min-plus: the NaN's partial sits on a layer-1 rank, never rank 0;
    the merge (a gather and a pairwise amin in layer order) keeps it, so
    every C entry it reaches is NaN and pruned by the decode, bitwise as
    on one process. gloo's all_reduce(MIN) would drop the NaN and keep
    layer 0's finite value in those entries. (Dense tiles spread the NaN
    through absent B entries, +inf, so it reaches more entries than the
    host oracle's sparse expand: the oracle pins the NaN-free operand.)"""
    a, b = _nan_case()
    plan = build_summa_plan(_port(a), _port(b), grid=2, layers=2, bs=16,
                            semiring=tsr.MIN_PLUS)
    one = run_device_summa(plan, device="cpu")
    clean = rsp.CSC(a.indptr, a.indices, np.nan_to_num(a.data, nan=1.0),
                    a.shape)
    assert one.nnz < _local(clean, b, "min_plus").nnz
    for rank, r in enumerate(ranks(8)["nan"]):
        _same(r["c"], one, rank)


# ---------------------------------------------------------------------------
# the session across ranks
# ---------------------------------------------------------------------------

WALLS = ("plan_seconds_saved", "plan_seconds")


def _no_walls(d):
    return {k: v for k, v in d.items() if k not in WALLS}


def _one_process(case):
    """The same calls on a one-process session: per call the CSC (or the
    error class), stats and last_call."""
    faults = case.get("faults", {})
    inj = next(iter(faults.values()), None)
    sess = SpGEMMSession(
        device="cpu",
        fault_injector=None if inj is None else FaultInjector(**inj),
        retry_policy=RetryPolicy(max_retries=2, backoff_s=0.0),
        retry_sleep=lambda s: None)
    out = []
    for call in case["calls"]:
        kw = {k: v for k, v in call.items() if k not in ("a", "b", "b_on")}
        if "semiring" in kw:
            kw["semiring"] = tsr.by_name(kw["semiring"])
        try:
            c = sess.matmul(worker.as_csc(call["a"]),
                            worker.as_csc(call["b"]), **kw)
            res = {"ok": True, "c": c}
        except ValidationError as e:
            res = {"ok": False, "error": type(e).__name__}
        res.update(stats=dict(sess.stats), last_call=dict(sess.last_call))
        out.append(res)
    return out


@pytest.mark.parametrize("name", ["cached_1d", "cached_2d", "cached_3d"])
def test_session_across_ranks_cold_hit_repack(ranks, name):
    world = 4 if name == "cached_1d" else 8
    case = (SESSION_4 if world == 4 else SESSION_8)[name]
    per_rank = ranks(world)[name]
    want = _one_process(case)
    a, b, _ = INT_CASES[1]
    oracles = [_local(a, b, "min_plus")] * 2 + \
        [_local(_twice(a), b, "min_plus")]
    for rank, calls in enumerate(per_rank):
        for k, (got, one, orc) in enumerate(zip(calls, want, oracles)):
            ctx = (name, rank, k)
            assert got["ok"], (ctx, got.get("message"))
            _same(got["c"], orc, ctx)
            _same(got["c"], one["c"], ctx)
            assert _no_walls(got["stats"]) == _no_walls(one["stats"]), ctx
            assert _no_walls(got["last_call"]) == \
                _no_walls(one["last_call"]), ctx
        hit, repack = calls[1], calls[2]
        assert hit["last_call"]["cache_hit"]
        assert not hit["last_call"]["repacked"]
        assert repack["last_call"]["repacked"]
        assert calls[0]["stats"]["traces"] == hit["stats"]["traces"] == \
            repack["stats"]["traces"] == 1
    # the payload moves on the cold call; a hit moves the same again
    sent = [sum(c[k]["bytes"]["sent"]["ring"] + c[k]["bytes"]["sent"]["gather"]
                for c in per_rank) for k in range(3)]
    assert sent[0] > 0 and sent[0] == sent[1] == sent[2]


def test_session_mismatched_operands_fail_on_every_rank(ranks):
    per_rank = ranks(8)["mismatch"]
    for rank, (bad, good) in enumerate(per_rank):
        assert not bad["ok"] and bad["error"] == "ValidationError", rank
        assert "different operands" in bad["message"]
        assert bad["stats"]["validation_failures"] == 1
        assert bad["stats"]["plan_cache_misses"] == 0
        # the group is still in step: the next call serves on every rank
        assert good["ok"], (rank, good.get("message"))
        _same(good["c"], _local(*INT_CASES[1][:2], "plus_times"), rank)


def test_session_geometry_larger_than_the_world_fails_on_every_rank(ranks):
    for rank, (r,) in enumerate(ranks(4)["too_large"]):
        assert not r["ok"] and r["error"] == "ValidationError", rank
        assert "needs 8 ranks, the world has 4" in r["message"]
        assert r["stats"]["validation_failures"] == 1


def test_session_fault_on_one_rank_retries_on_every_rank(ranks):
    case = SESSION_4["fault_retry"]
    (one,) = _one_process(case)
    for rank, (r,) in enumerate(ranks(4)["fault_retry"]):
        assert r["ok"], (rank, r.get("message"))
        _same(r["c"], _local(*INT_CASES[1][:2], "plus_times"), rank)
        assert r["stats"]["retries"] == 1, rank
        assert r["last_call"]["retries"] == 1 and \
            not r["last_call"]["degraded"]
        assert _no_walls(r["stats"]) == _no_walls(one["stats"])


def test_session_launch_failure_mid_ring_retries_on_every_rank(ranks):
    """A schedule run that raises on rank 2 in its first chunk: the rank
    keeps exchanging the later chunks, raises after the ring, and every
    rank retries the execute stage — no rank waits for a message that
    never comes."""
    for rank, (r,) in enumerate(ranks(4)["launch_retry"]):
        assert r["ok"], (rank, r.get("message"))
        _same(r["c"], _local(*INT_CASES[1][:2], "plus_times"), rank)
        assert r["stats"]["retries"] == 1 and r["stats"]["fallbacks"] == 0
        assert not r["last_call"]["degraded"]


def test_session_downgrade_serves_the_idle_ranks(ranks):
    """A fault that exhausts the 3d rung's retries on rank 5 moves every
    rank to the 2d rung, which runs on ranks 0-3; ranks 4-7 take no part
    and still return the result."""
    case = SESSION_8["downgrade"]
    (one,) = _one_process(case)
    assert one["last_call"]["algorithm"] == "2d"
    a, b, _ = INT_CASES[0]
    for rank, (r,) in enumerate(ranks(8)["downgrade"]):
        assert r["ok"], (rank, r.get("message"))
        _same(r["c"], _local(a, b, "plus_times"), rank)
        lc = r["last_call"]
        assert lc["algorithm"] == "2d" and lc["degraded"], rank
        assert r["stats"]["fallbacks"] == 1 and r["stats"]["retries"] == 2
        assert _no_walls(r["stats"]) == _no_walls(one["stats"])
        moved = r["bytes"]["sent"]["gather"]
        assert (moved > 0) == (rank < 4), rank


def test_meshes_of_the_first_ranks(ranks):
    """On 2 ranks a (1, 2, 1) mesh holds both, in order; a (2, 2, 1) mesh
    is refused on every rank with a ValidationError naming the world."""
    res = ranks(2)
    for rank, r in enumerate(res["mesh_of_two"]):
        assert tuple(r["coordinate"]) == (0, rank, 0)
    for r in res["mesh_too_large"]:
        assert r["error"] == "ValidationError"
        assert "needs 4 ranks, the world has 2" in r["message"]


@pytest.mark.parametrize("geo", ["1d", "1d-chunk2", "2d", "3d"])
def test_a_ranks_plan_is_the_whole_plan_with_its_own_payloads(geo):
    """A rank's plan (``payload_parts=(p,)``) equals the whole plan in every
    field and stat but the payload stacks, which hold part p's alone, as
    a values-only repack of it does; a rank outside the mesh (``()``)
    holds none. The whole plan is the reference's (test_torch_ring.py,
    test_torch_summa.py)."""
    a, b, bs = INT_CASES[1]
    a, b = _port(a), _port(b)
    if geo.startswith("1d"):
        chunk = 2 if geo.endswith("chunk2") else None
        build = lambda **kw: build_device_plan(  # noqa: E731
            a, b, nparts=4, bs=bs, semiring=tsr.MIN_PLUS, chunk=chunk, **kw)
        repack, parts = repack_ring_payloads, 4
    else:
        layers = 2 if geo == "3d" else 1
        build = lambda **kw: build_summa_plan(  # noqa: E731
            a, b, grid=2, layers=layers, bs=bs, semiring=tsr.MIN_PLUS, **kw)
        repack, parts = repack_summa_payloads, 4 * layers
    whole = build()
    flat = [x.reshape((parts,) + x.shape[-3:])
            for x in (whole.a_tiles, whole.b_tiles)]
    twice = _port(_twice(INT_CASES[1][0]))
    whole_a, _ = repack(whole, twice, None)
    whole_a = whole_a.reshape((parts,) + whole_a.shape[-3:])
    for held in [(p,) for p in range(parts)] + [()]:
        mine = build(payload_parts=held)
        assert mine.payload_parts == held
        for f in dataclasses.fields(whole):
            x, y = getattr(mine, f.name), getattr(whole, f.name)
            if f.name in ("a_tiles", "b_tiles", "payload_parts"):
                continue
            if f.name == "stats":
                assert set(x) == set(y)
                assert all(np.array_equal(x[k], y[k]) for k in y
                           if k != "plan_seconds")
            elif isinstance(y, np.ndarray):
                assert np.array_equal(x, y), f.name
            elif f.name.startswith("part_"):
                assert np.array_equal(x.splits, y.splits)
            elif f.name != "semiring":
                assert x == y, f.name
        for got, want in zip((mine.a_tiles, mine.b_tiles), flat):
            assert got.shape == (len(held),) + want.shape[1:]
            assert np.array_equal(got, want[list(held)])
        new_a, new_b = repack(mine, twice, None)
        assert new_b is None and np.array_equal(new_a, whole_a[list(held)])


def test_meshes_need_a_process_group():
    """Without a process group, or with too few ranks, a mesh is refused
    with a ValidationError naming the world, as the reference refuses too
    few devices."""
    with pytest.raises(ValidationError, match="no process group"):
        device_grid_mesh((2, 2, 1), ("gr", "gc", "gl"))
