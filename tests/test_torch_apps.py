"""The port's apps against the reference's, on the CPU.

The same seeded inputs go through ``repro.apps`` (run as the reference's
own tests run it: its session's default engine, Pallas in interpret mode,
on one device) and ``repro_torch.apps`` with ``device="cpu"`` (the plain
PyTorch version of the ``bsr_spgemm`` kernel), at the reference tests'
sizes: graphs of 1-64 vertices, bs 16.

Tolerances, stated per comparison:

* sketch and AMG Galerkin: integer-valued operands, so every partial sum
  is exact — bitwise against the reference (and a dense numpy oracle);
* MCL: clusters and iteration counts equal, operators within rtol 1e-5,
  atol 1e-7 (float32 expansion sums in another order); the host operators
  bitwise;
* BC: depths and call counts equal, scores within rtol 1e-6 of the
  reference's device run (the backward sweep's float32 payloads are not
  integers) and within rtol 1e-5 of brute-force Brandes in float64;
* resume after an injected fault: bitwise against the uninterrupted run.

Without a GPU, an app asked for no device and given no session raises
rather than running on the CPU.
"""

import importlib

import numpy as np
import pytest
import torch

import repro.apps as R
from repro.core import SpGEMMSession as RSession
from repro.core import sparse as rsp
from repro.core.semiring import BOOL_OR_AND as R_BOOL_OR_AND
from repro_torch.apps import (bc_batch, count_sketch, device_spgemm_fn,
                              galerkin_product, mcl, sketch_apply,
                              sketch_stream)
from repro_torch.core import BOOL_OR_AND, spgemm
from repro_torch.core.convert import csc_from_arrays
from repro_torch.core.session import SpGEMMSession, session_or_new
from repro_torch.core.validate import DeviceExecError, SpGEMMError
from repro_torch.runtime import FaultInjector, RetryPolicy

# the packages export the function ``mcl`` under the module's name
rmcl = importlib.import_module("repro.apps.mcl")
tmcl = importlib.import_module("repro_torch.apps.mcl")


def _port(mat):
    return csc_from_arrays(mat.shape, mat.indptr, mat.indices, mat.data)


def _cpu(**kw):
    """A CPU session whose retries never wall-clock-sleep."""
    return SpGEMMSession(device="cpu", retry_sleep=lambda _: None,
                         retry_rng=np.random.default_rng(7), **kw)


def _bitwise(c, ref):
    assert c.shape == ref.shape
    assert np.array_equal(c.indptr, ref.indptr)
    assert np.array_equal(c.indices, ref.indices)
    assert c.data.dtype == ref.data.dtype
    assert c.data.tobytes() == ref.data.tobytes()


def _int_matrix(m, n, seed, d=4.0):
    a = rsp.erdos_renyi(m, n, d, seed=seed)
    a.data[:] = np.rint(2 * a.data)
    a.data[a.data == 0] = 1.0
    return a


# ---------------------------------------------------------------------------
# the session helper, and the card rule
# ---------------------------------------------------------------------------

def test_session_or_new_refuses_device_beside_a_session():
    s = _cpu()
    assert session_or_new(s, None) is s
    with pytest.raises(ValueError, match="device is fixed"):
        session_or_new(s, "cpu")
    fresh = session_or_new(None, "cpu")
    assert isinstance(fresh, SpGEMMSession) and fresh.device.type == "cpu"
    with pytest.raises(ValueError, match="device is fixed"):
        mcl(_port(rsp.erdos_renyi(8, 8, 2.0, seed=0)), session=s,
            device="cpu")


def _no_gpu_calls():
    a = _port(_int_matrix(20, 20, seed=2))
    a.data[:] = np.abs(a.data)
    s = count_sketch(4, 20)
    return {
        "session_or_new": lambda: session_or_new(None, None),
        "mcl": lambda: mcl(a),
        "mcl_cuda": lambda: mcl(a, device="cuda"),
        "sketch_apply": lambda: sketch_apply(a, s),
        "sketch_stream": lambda: sketch_stream([a], dim=4),
        "galerkin_device": lambda: galerkin_product(a, backend="device",
                                                    coarsening=4),
        "device_spgemm_fn": lambda: device_spgemm_fn(),
    }


@pytest.mark.parametrize("name", sorted(_no_gpu_calls()))
def test_apps_raise_without_a_gpu(monkeypatch, name):
    """No ``device`` and no session means the card: without one the call
    raises before any multiply, and never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(SpGEMMSession, "matmul",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _no_gpu_calls()[name]()
    assert not ran


# ---------------------------------------------------------------------------
# randomized sketching (bitwise: integer operands)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,n,seed", [(9, 50, 4), (11, 5, 0), (3, 1, 1),
                                        (256, 4096, 0)])
def test_count_sketch_equals_reference(dim, n, seed):
    _bitwise(count_sketch(dim, n, seed=seed),
             R.count_sketch(dim, n, seed=seed))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("nparts", [1, 4])
def test_sketch_bitwise_against_reference(side, nparts):
    """S·A and A·Sᵀ on dims that are not tile multiples: bitwise against
    the reference's session (one part, its one device) and numpy."""
    a = _int_matrix(50, 37, seed=1)
    n = a.nrows if side == "left" else a.ncols
    s = R.count_sketch(9, n, seed=4)
    res = sketch_apply(_port(a), _port(s), side=side, bs=16, nparts=nparts,
                       device="cpu")
    ref = R.sketch_apply(a, s, side=side, bs=16)
    _bitwise(res.sketched, ref.sketched)
    dense = (s.to_dense() @ a.to_dense() if side == "left"
             else a.to_dense() @ s.to_dense().T)
    assert np.array_equal(res.sketched.to_dense(), dense.astype(np.float32))
    assert res.sketched.shape == ((9, 37) if side == "left" else (50, 9))
    assert not res.cache_hit and not ref.cache_hit
    if nparts == 1:
        assert res.comm_bytes == ref.comm_bytes


@pytest.mark.parametrize("case", ["empty_rows", "one_by_one"])
def test_sketch_degenerate_shapes(case):
    """dim >> n leaves sketch rows no column hashes to; a 1×1 input."""
    if case == "empty_rows":
        a, s = _int_matrix(5, 4, seed=2), R.count_sketch(11, 5, seed=0)
        assert s.nnz == 5
    else:
        a, s = rsp.from_dense(np.array([[3.0]])), R.count_sketch(3, 1,
                                                                  seed=1)
    res = sketch_apply(_port(a), _port(s), side="left", bs=16,
                       device="cpu")
    _bitwise(res.sketched, R.sketch_apply(a, s, side="left",
                                          bs=16).sketched)
    assert np.array_equal(res.sketched.to_dense(),
                          (s.to_dense() @ a.to_dense()).astype(np.float32))


def test_sketch_stream_repacks_and_matches_reference():
    """One operator over a fixed-structure stream: one cold call, then
    three hits with a values-only repack each, every output bitwise."""
    base = _int_matrix(40, 23, seed=6)
    mats = []
    for i in range(4):
        m = base.astype(np.float64)
        m.data[:] = base.data + i
        m.data[m.data == 0] = 5.0
        mats.append(m)
    session, rsession = _cpu(), RSession()
    outs = sketch_stream([_port(m) for m in mats], dim=8, seed=3,
                         session=session, bs=16)
    refs = R.sketch_stream(mats, dim=8, seed=3, session=rsession, bs=16)
    assert [o.cache_hit for o in outs] == [False, True, True, True]
    assert session.stats["payload_repacks"] == 3 == \
        rsession.stats["payload_repacks"]
    _bitwise(outs[0].sketch, refs[0].sketch)
    for o, r in zip(outs, refs):
        _bitwise(o.sketched, r.sketched)


def test_sketch_stream_empty():
    assert sketch_stream([], dim=4, device="cpu") == []


# ---------------------------------------------------------------------------
# AMG Galerkin product (bitwise: integer operands)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("right_algorithm", ["outer", "1d"])
def test_galerkin_matches_reference(backend, right_algorithm):
    """RᵀAR of a 2D Laplacian: the coarse operator bitwise, and the bytes
    and flops equal, on both backends (the device one on the reference's
    one device: nparts=1)."""
    a = rsp.laplacian_2d(10)
    r = rsp.restriction_operator(a, coarsening=8)
    nparts = 4 if backend == "host" else 1
    kw = dict(nparts=nparts, right_algorithm=right_algorithm,
              backend=backend, bs=16)
    res = galerkin_product(_port(a), r=_port(r),
                           session=_cpu() if backend == "device" else None,
                           **kw)
    ref = R.galerkin_product(a, r=r, **kw)
    _bitwise(res.coarse, ref.coarse)
    for k in ("left_bytes", "right_bytes", "left_flops", "right_flops",
              "right_algorithm"):
        assert getattr(res, k) == getattr(ref, k), k
    want = r.to_dense().T @ a.to_dense() @ r.to_dense()
    np.testing.assert_array_equal(res.coarse.to_dense(),
                                  want.astype(res.coarse.data.dtype))


def test_galerkin_device_repeat_hits_with_logical_parts():
    """The ring's logical parts (nparts=4 on one device) give the same
    coarse operator, and a repeated setup on one session is two hits."""
    a = rsp.laplacian_2d(10)
    r = rsp.restriction_operator(a, coarsening=8)
    ref = R.galerkin_product(a, r=r, backend="host")
    s = _cpu()
    for _ in range(2):
        res = galerkin_product(_port(a), r=_port(r), nparts=4,
                               backend="device", bs=16, session=s)
        np.testing.assert_array_equal(res.coarse.to_dense(),
                                      ref.coarse.to_dense())
    assert s.stats["plan_cache_misses"] == 2
    assert s.stats["plan_cache_hits"] == 2
    assert s.stats["payload_repacks"] == 0


# ---------------------------------------------------------------------------
# Markov clustering (rtol 1e-5, atol 1e-7 on operators)
# ---------------------------------------------------------------------------

def _mcl_case(name):
    if name == "one_by_one":
        return rsp.from_coo([0], [0], [2.0], (1, 1)), {}
    if name == "fully_pruned":
        g = rsp.erdos_renyi(20, 20, 3.0, seed=1)
        g.data[:] = np.abs(g.data) + 0.1
        return g, dict(prune_threshold=2.0)
    if name == "planted":
        g = rsp.block_diagonal_noise(48, 3, d_in=6.0, d_out=0.0, seed=5)
        g.data[:] = np.abs(g.data) + 0.5
        return g, {}
    g = rsp.block_diagonal_noise(50, 5, d_in=5.0, d_out=0.1, seed=3)
    g.data[:] = np.abs(g.data) + 0.1
    return g, {}


MCL_CASES = ("community", "planted", "fully_pruned", "one_by_one")


@pytest.mark.parametrize("name", MCL_CASES)
def test_mcl_matches_reference_and_dense_oracle(name):
    g, kw = _mcl_case(name)
    res = mcl(_port(g), bs=16, device="cpu", **kw)
    ref = R.mcl(g, bs=16, **kw)
    assert res.iterations == ref.iterations
    assert res.converged == ref.converged and res.converged
    assert np.array_equal(res.clusters, ref.clusters)
    assert res.comm_bytes == ref.comm_bytes
    np.testing.assert_allclose(res.matrix.to_dense(), ref.matrix.to_dense(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(res.chaos, ref.chaos, rtol=1e-5, atol=1e-7)
    dense, it = rmcl.mcl_dense_reference(g.to_dense(), **kw)
    assert it == res.iterations
    np.testing.assert_allclose(res.matrix.to_dense(), dense, rtol=1e-5,
                               atol=1e-7)
    port_dense, port_it = tmcl.mcl_dense_reference(g.to_dense(), **kw)
    assert port_it == it and port_dense.tobytes() == dense.tobytes()
    if name == "fully_pruned":
        assert res.matrix.nnz == 0
        np.testing.assert_array_equal(res.clusters, np.arange(20))


def test_mcl_logical_parts_match_one_part():
    g, _ = _mcl_case("community")
    one = mcl(_port(g), bs=16, device="cpu")
    four = mcl(_port(g), bs=16, nparts=4, device="cpu")
    assert four.iterations == one.iterations
    assert np.array_equal(four.clusters, one.clusters)
    np.testing.assert_allclose(four.matrix.to_dense(), one.matrix.to_dense(),
                               rtol=1e-5, atol=1e-7)


def test_mcl_session_amortizes_converged_tail():
    """Once the pattern stops moving, expansions are plan-cache hits."""
    g, _ = _mcl_case("planted")
    session = _cpu()
    res = mcl(_port(g), session=session, bs=16)
    assert res.iterations >= 3
    assert session.stats["plan_cache_hits"] >= 1
    assert session.stats["plan_cache_hits"] + \
        session.stats["plan_cache_misses"] == res.iterations


def _readout_cases():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((12, 9))
    dense[rng.random(dense.shape) < 0.5] = 0.0
    dense[:, 2] = 0.0                          # an empty column
    dense[:, 3] = -np.abs(dense[:, 3]) - 0.1   # full, every value < 0
    dense[[1, 5, 7], 4] = 0.5                  # a tie: the first row wins
    dense[:, 5] = np.where(dense[:, 5] > 0, -1.0, 0.0)   # max is a zero
    dense[[0, 2], 6] = [np.nan, 3.0]           # NaN: singleton
    square = np.abs(rng.standard_normal((6, 6)))
    return [dense, square, np.zeros((4, 4)), np.array([[2.0]])]


@pytest.mark.parametrize("case", range(4))
def test_mcl_host_operators_equal_reference(case):
    """Cluster readout (sparse here, dense in the reference) and the
    elementwise operators, bitwise."""
    dense = _readout_cases()[case]
    m = rsp.from_dense(dense)
    m = rsp.CSC(m.indptr, m.indices, dense[m.indices, np.repeat(
        np.arange(m.ncols), np.diff(m.indptr))], m.shape)   # keeps the NaN
    np.testing.assert_array_equal(tmcl.clusters_from_matrix(_port(m)),
                                  rmcl.clusters_from_matrix(m))
    if np.isnan(dense).any() or dense.shape[0] != dense.shape[1]:
        return
    pm = _port(m)
    _bitwise(tmcl.add_self_loops(pm, 0.5), rmcl.add_self_loops(m, 0.5))
    _bitwise(tmcl.column_normalize(pm), rmcl.column_normalize(m))
    _bitwise(tmcl.inflate(pm, 2.0), rmcl.inflate(m, 2.0))
    _bitwise(tmcl.prune_small(pm, 0.3), rmcl.prune_small(m, 0.3))
    assert tmcl.chaos(pm) == rmcl.chaos(m)


# ---------------------------------------------------------------------------
# batched betweenness centrality (rtol 1e-6 against the reference)
# ---------------------------------------------------------------------------

def _graph(n=50, d=3.0, seed=0):
    a = rsp.symmetrize(rsp.erdos_renyi(n, n, d, seed=seed))
    dense = (a.to_dense() != 0).astype(float)
    np.fill_diagonal(dense, 0)
    rows, cols = np.nonzero(dense)
    return rsp.from_coo(rows, cols, np.ones(len(rows)), (n, n))


def _bc_bruteforce(adj, sources):
    n = adj.shape[0]
    scores = np.zeros(n)
    for s in sources:
        dist = np.full(n, -1)
        dist[s] = 0
        sigma = np.zeros(n)
        sigma[s] = 1
        order, frontier, d = [s], [s], 0
        while frontier:
            nxt = []
            for v in frontier:
                for w in np.nonzero(adj[:, v])[0]:
                    if dist[w] == -1:
                        dist[w] = d + 1
                        nxt.append(w)
                        order.append(w)
                    if dist[w] == d + 1:
                        sigma[w] += sigma[v]
            frontier = nxt
            d += 1
        delta = np.zeros(n)
        for w in reversed(order):
            for v in np.nonzero(adj[:, w])[0]:
                if dist[v] == dist[w] - 1:
                    delta[v] += sigma[v] / sigma[w] * (1 + delta[w])
        delta[s] = 0
        scores += delta
    return scores


def _same_counts(res, ref):
    assert res.depths == ref.depths
    assert res.fwd_spgemm_calls == ref.fwd_spgemm_calls
    assert res.bwd_spgemm_calls == ref.bwd_spgemm_calls
    assert res.comm_bytes == ref.comm_bytes


@pytest.mark.parametrize("seed", [0, 3])
def test_bc_matches_reference_and_bruteforce(seed):
    a = _graph(seed=seed)
    sources = np.array([0, 7, 13])
    fn = device_spgemm_fn(bs=16, device="cpu")
    res = bc_batch(_port(a), sources, spgemm_fn=fn)
    ref = R.bc_batch(a, sources, spgemm_fn=R.device_spgemm_fn(bs=16))
    _same_counts(res, ref)
    np.testing.assert_allclose(res.scores, ref.scores, rtol=1e-6)
    oracle = _bc_bruteforce(a.to_dense(), sources)
    np.testing.assert_allclose(res.scores, oracle, rtol=1e-5, atol=1e-9)
    # a symmetric graph: the backward sweep replays the forward levels'
    # structures, so every backward call is a hit with a repack
    assert fn.session.stats["plan_cache_misses"] == res.fwd_spgemm_calls
    assert fn.session.stats["payload_repacks"] == res.bwd_spgemm_calls
    # the host oracle path (no spgemm_fn) in float64
    host = bc_batch(_port(a), sources)
    np.testing.assert_allclose(host.scores, oracle, atol=1e-9)
    np.testing.assert_array_equal(host.scores,
                                  R.bc_batch(a, sources).scores)


def test_bc_logical_parts_match_one_part():
    a = _graph(seed=1)
    sources = np.array([2, 5])
    one = bc_batch(_port(a), sources,
                   spgemm_fn=device_spgemm_fn(bs=16, device="cpu"))
    four = bc_batch(_port(a), sources,
                    spgemm_fn=device_spgemm_fn(nparts=4, bs=16,
                                               device="cpu"))
    assert four.depths == one.depths
    np.testing.assert_allclose(four.scores, one.scores, rtol=1e-6)


def test_bc_bool_forward_routes_to_the_session():
    """``fwd_semiring=BOOL_OR_AND`` reaches the session's forward calls
    (its cache keys) and the backward sweep stays plus-times; the scores
    match the reference's bool run."""
    a = _graph(seed=2)
    sources = np.array([1, 4])
    fn = device_spgemm_fn(bs=16, device="cpu")
    res = bc_batch(_port(a), sources, spgemm_fn=fn,
                   fwd_semiring=BOOL_OR_AND)
    ref = R.bc_batch(a, sources, spgemm_fn=R.device_spgemm_fn(bs=16),
                     fwd_semiring=R_BOOL_OR_AND)
    _same_counts(res, ref)
    np.testing.assert_allclose(res.scores, ref.scores, rtol=1e-6)
    names = [key[5] for key in fn.session._cache]
    assert names.count("bool_or_and") == res.fwd_spgemm_calls
    assert names.count("plus_times") == res.bwd_spgemm_calls


# ---------------------------------------------------------------------------
# resume after a fault (bitwise)
# ---------------------------------------------------------------------------

def test_mcl_resumes_bitwise_after_mid_run_fault(tmp_path):
    g = rsp.block_diagonal_noise(32, 4, d_in=5.0, d_out=0.1, seed=3)
    ref = mcl(_port(g), bs=16, session=_cpu())
    # every early iteration is a cold call firing plan + compile + execute
    # = 3, so arm_after=6 kills iteration 3; the CPU session has no rung
    # below its engine, so the fault surfaces
    inj = FaultInjector(seed=0, rates={"execute": 1.0}, arm_after=6)
    broken = _cpu(fault_injector=inj,
                  retry_policy=RetryPolicy(max_retries=0, backoff_s=0.0))
    ckpt_dir = str(tmp_path / "mcl")
    with pytest.raises(SpGEMMError):
        mcl(_port(g), bs=16, session=broken, checkpoint_dir=ckpt_dir)
    assert inj.total_injected == 1
    from repro_torch.checkpoint import latest_step
    assert latest_step(ckpt_dir) == 2

    res = mcl(_port(g), bs=16, session=_cpu(), checkpoint_dir=ckpt_dir)
    assert res.iterations == ref.iterations
    assert res.converged == ref.converged and res.chaos == ref.chaos
    assert np.array_equal(res.clusters, ref.clusters)
    _bitwise(res.matrix, ref.matrix)
    assert res.comm_bytes == ref.comm_bytes


def test_bc_resumes_bitwise_after_a_backward_fault(tmp_path):
    """The forward sweep completes, the first backward multiply raises;
    the re-call resumes mid-sweep to the uninterrupted scores."""
    a = _graph(n=24, d=2.5, seed=3)
    sources = np.array([0, 5, 9])
    ref = bc_batch(_port(a), sources,
                   spgemm_fn=device_spgemm_fn(bs=16, device="cpu"))

    def failing(fail_at):
        inner = device_spgemm_fn(bs=16, device="cpu")
        calls = {"n": 0}

        def fn(x, y, sr):
            calls["n"] += 1
            if calls["n"] == fail_at:
                raise DeviceExecError("injected mid-sweep", stage="execute")
            return inner(x, y, sr)
        return fn

    ckpt_dir = str(tmp_path / "bc")
    with pytest.raises(SpGEMMError):
        bc_batch(_port(a), sources,
                 spgemm_fn=failing(ref.fwd_spgemm_calls + 1),
                 checkpoint_dir=ckpt_dir)
    res = bc_batch(_port(a), sources, spgemm_fn=failing(None),
                   checkpoint_dir=ckpt_dir)
    assert res.scores.tobytes() == ref.scores.tobytes()
    _same_counts(res, ref)


def test_bc_host_resume_matches_reference_fault_test(tmp_path):
    """The reference fault test's host path, failing on the 4th multiply."""
    a = rsp.symmetrize(rsp.erdos_renyi(24, 24, 2.5, seed=3))
    a.data[:] = 1.0

    def make_fn(fail_at=None):
        calls = {"n": 0}

        def fn(x, y, sr):
            calls["n"] += 1
            if fail_at is not None and calls["n"] >= fail_at:
                raise DeviceExecError("injected mid-sweep", stage="execute")
            return spgemm(x, y, sr), 11
        return fn

    sources = np.array([0, 5, 9])
    ref = bc_batch(_port(a), sources, spgemm_fn=make_fn())
    ckpt_dir = str(tmp_path / "bc")
    with pytest.raises(SpGEMMError):
        bc_batch(_port(a), sources, spgemm_fn=make_fn(fail_at=4),
                 checkpoint_dir=ckpt_dir)
    res = bc_batch(_port(a), sources, spgemm_fn=make_fn(),
                   checkpoint_dir=ckpt_dir)
    assert res.scores.tobytes() == ref.scores.tobytes()
    assert res.depths == ref.depths and res.comm_bytes == ref.comm_bytes


def test_mcl_resumes_from_a_reference_snapshot(tmp_path):
    """A reference run stopped by its ``max_iter`` leaves snapshots; the
    port resumes from the last one and reaches the reference's full-run
    clusters and iteration count."""
    g, _ = _mcl_case("community")
    full = R.mcl(g, bs=16)
    ckpt_dir = str(tmp_path / "mcl")
    part = R.mcl(g, bs=16, max_iter=2, checkpoint_dir=ckpt_dir)
    assert part.iterations == 2 and not part.converged
    res = mcl(_port(g), bs=16, device="cpu", checkpoint_dir=ckpt_dir)
    assert res.iterations == full.iterations and res.converged
    assert np.array_equal(res.clusters, full.clusters)
    np.testing.assert_allclose(res.matrix.to_dense(),
                               full.matrix.to_dense(), rtol=1e-5, atol=1e-7)
