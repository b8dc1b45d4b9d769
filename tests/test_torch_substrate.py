"""The port's host substrate against the reference's, on the same inputs.

Generators and constructors, permutations, blockization, product
schedules, visit flags, partitions, the fetch plan, the 2D/3D volume
models, the host oracles (1D, SUMMA, Split-3D, outer product), the
partitioner and ``validate_blocksparse`` are plain numpy in both packages,
so the port's outputs must be array-equal to ``repro.core.*`` (tolerance:
none — exact equality of every array and scalar). The semiring's torch
side is held bitwise against the reference's jnp side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.blocksparse as rbs
import repro.core.local_spgemm as rls
import repro.core.partition as rpart
import repro.core.plan as rplan
import repro.core.semiring as rsr
import repro.core.sparse as rsp
import repro.core.validate as rval
import repro_torch.core.blocksparse as tbs
import repro_torch.core.local_spgemm as tls
import repro_torch.core.partition as tpart
import repro_torch.core.plan as tplan
import repro_torch.core.semiring as tsr
import repro_torch.core.sparse as tsp
import repro_torch.core.validate as tval
from repro.core.spgemm_1d import spgemm_1d as r_spgemm_1d
from repro.core.spgemm_2d import spgemm_2d as r_spgemm_2d
from repro.core.spgemm_3d import spgemm_3d as r_spgemm_3d
from repro.core.spgemm_outer import spgemm_outer_1d as r_spgemm_outer_1d
from repro_torch.core.convert import csc_from_arrays
from repro_torch.core.spgemm_1d import spgemm_1d as t_spgemm_1d
from repro_torch.core.spgemm_2d import spgemm_2d as t_spgemm_2d
from repro_torch.core.spgemm_3d import spgemm_3d as t_spgemm_3d
from repro_torch.core.spgemm_outer import spgemm_outer_1d as t_spgemm_outer_1d

SEMIRINGS = ("plus_times", "bool_or_and", "min_plus")

GENERATORS = {
    "erdos_renyi": lambda m: m.erdos_renyi(90, 70, 4.0, seed=3),
    "banded_clustered": lambda m: m.banded_clustered(150, 12, 5.0, seed=4),
    "laplacian_2d": lambda m: m.laplacian_2d(13),
    "rmat": lambda m: m.rmat(7, 6, seed=5),
}


def _same_csc(x, y):
    assert x.shape == y.shape
    assert np.array_equal(x.indptr, y.indptr)
    assert np.array_equal(x.indices, y.indices)
    assert np.array_equal(x.data, y.data)
    assert x.data.dtype == y.data.dtype


def _port(mat):
    return csc_from_arrays(mat.shape, mat.indptr, mat.indices, mat.data)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_array_equal(name):
    _same_csc(GENERATORS[name](tsp), GENERATORS[name](rsp))


def test_csc_methods_array_equal():
    r = rsp.erdos_renyi(40, 30, 3.0, seed=1)
    t = _port(r)
    _same_csc(t.transpose(), r.transpose())
    _same_csc(t.col_slice(5, 21), r.col_slice(5, 21))
    ids = np.array([3, 0, 17, 29])
    _same_csc(t.select_cols(ids), r.select_cols(ids))
    _same_csc(t.prune(0.5), r.prune(0.5))
    assert np.array_equal(t.to_dense(), r.to_dense())
    starts, lens = np.array([0, 7, 3]), np.array([2, 0, 4])
    assert np.array_equal(tsp._segment_indices(starts, lens),
                          rsp._segment_indices(starts, lens))
    sq = rsp.erdos_renyi(30, 30, 3.0, seed=2)
    _same_csc(tsp.symmetrize(_port(sq)), rsp.symmetrize(sq))


@pytest.mark.parametrize("bs", [1, 8, 16])
@pytest.mark.parametrize("srname", SEMIRINGS)
def test_from_csc_array_equal(bs, srname):
    r = rsp.banded_clustered(70, 9, 4.0, seed=2)
    fill = rsr.by_name(srname).zero
    rb = rbs.from_csc(r, bs=bs, fill=fill)
    tb = tbs.from_csc(_port(r), bs=bs, fill=fill)
    for f in ("tiles", "tile_rows", "tile_cols"):
        assert np.array_equal(getattr(tb, f), getattr(rb, f)), f
    assert (tb.shape, tb.orig_shape, tb.bs) == (rb.shape, rb.orig_shape,
                                               rb.bs)
    assert tb.fill == rb.fill or (np.isinf(tb.fill) and np.isinf(rb.fill))
    _same_csc(tb.to_csc(semiring=tsr.by_name(srname)),
              rb.to_csc(semiring=rsr.by_name(srname)))


@pytest.mark.parametrize("bs", [1, 8, 16])
def test_build_schedule_array_equal(bs):
    ra = rsp.erdos_renyi(60, 50, 3.0, seed=6)
    rb_ = rsp.banded_clustered(50, 7, 3.0, seed=7)
    rs = rbs.build_schedule(rbs.from_csc(ra, bs=bs), rbs.from_csc(rb_, bs=bs))
    ts = tbs.build_schedule(tbs.from_csc(_port(ra), bs=bs),
                            tbs.from_csc(_port(rb_), bs=bs))
    for f in ("a_slot", "b_slot", "c_slot", "c_rows", "c_cols", "nprod",
              "nc", "flops"):
        assert np.array_equal(getattr(ts, f), getattr(rs, f)), f
    assert np.array_equal(ts.flags(), rs.flags())


@pytest.mark.parametrize("shape", [(0,), (1,), (17,), (3, 12)])
def test_flags_from_c_slot_array_equal(shape):
    rng = np.random.default_rng(sum(shape))
    c = np.sort(rng.integers(0, 5, size=shape), axis=-1)
    assert np.array_equal(tbs.flags_from_c_slot(c), rbs.flags_from_c_slot(c))


@pytest.mark.parametrize("ncols,nparts", [(100, 4), (7, 8), (128, 1)])
def test_partition_array_equal(ncols, nparts):
    tp = tplan.Partition1D.balanced(ncols, nparts)
    rp = rplan.Partition1D.balanced(ncols, nparts)
    assert np.array_equal(tp.splits, rp.splits)
    ids = np.arange(ncols)
    assert np.array_equal(tp.owner_of(ids), rp.owner_of(ids))
    assert np.array_equal(tp.widths(), rp.widths())
    assert tplan.BYTES_PER_NNZ == rplan.BYTES_PER_NNZ


@pytest.mark.parametrize("nblocks", [1, 3, 2048])
def test_build_fetch_plan_equal(nblocks):
    ra = rsp.erdos_renyi(80, 80, 3.0, seed=8)
    rb_ = rsp.banded_clustered(80, 10, 3.0, seed=9)
    rp = rplan.build_fetch_plan(ra, rb_, rplan.Partition1D.balanced(80, 4),
                                rplan.Partition1D.balanced(80, 4), nblocks)
    tp = tplan.build_fetch_plan(_port(ra), _port(rb_),
                                tplan.Partition1D.balanced(80, 4),
                                tplan.Partition1D.balanced(80, 4), nblocks)
    assert len(tp.pairs) == len(rp.pairs)
    for x, y in zip(tp.pairs, rp.pairs):
        assert (x.dst, x.src, x.required_bytes, x.fetched_bytes,
                x.n_messages) == (y.dst, y.src, y.required_bytes,
                                  y.fetched_bytes, y.n_messages)
        assert np.array_equal(x.required_cols, y.required_cols)
        assert np.array_equal(x.fetched_cols, y.fetched_cols)
    for x, y in zip(tp.local_required, rp.local_required):
        assert np.array_equal(x, y)
    assert tp.cv_over_mema == rp.cv_over_mema
    assert np.array_equal(tp.per_process_messages(),
                          rp.per_process_messages())


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_host_oracles_array_equal(srname):
    ra = rsp.banded_clustered(64, 8, 4.0, seed=10)
    rb_ = rsp.erdos_renyi(64, 48, 3.0, seed=11)
    ta, tb = _port(ra), _port(rb_)
    _same_csc(tls.spgemm(ta, tb, tsr.by_name(srname)),
              rls.spgemm(ra, rb_, rsr.by_name(srname)))
    assert tls.spgemm_flops(ta, tb) == rls.spgemm_flops(ra, rb_)
    t = t_spgemm_1d(ta, tb, 4, nblocks=3, semiring=tsr.by_name(srname))
    r = r_spgemm_1d(ra, rb_, 4, nblocks=3, semiring=rsr.by_name(srname))
    _same_csc(t.concat(), r.concat())
    assert np.array_equal(t.comm_bytes, r.comm_bytes)
    assert np.array_equal(t.flops, r.flops)


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_semiring_host_side_equal(srname):
    t, r = tsr.by_name(srname), rsr.by_name(srname)
    rng = np.random.default_rng(12)
    v = rng.standard_normal(20)
    v[::4] = t.zero
    s = np.array([0, 3, 9, 15])
    assert t.zero == r.zero or (np.isinf(t.zero) and np.isinf(r.zero))
    assert np.array_equal(t.mul(v, v[::-1]), r.mul(v, v[::-1]))
    assert np.array_equal(t.add_reduceat(v, s), r.add_reduceat(v, s))
    assert np.array_equal(t.prune_mask(v), r.prune_mask(v))
    assert np.array_equal(t.fill((2, 3)), r.fill((2, 3)))


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_semiring_device_contract_matches_reference(srname):
    """The torch device side against the reference's jnp side on the same
    integer-valued tiles: matmul, add, tile_combine, segment_reduce —
    bitwise (segments no product targets: the port gives the identity)."""
    t, r = tsr.by_name(srname), rsr.by_name(srname)
    rng = np.random.default_rng(13)
    a = rng.integers(-3, 4, size=(5, 8, 8)).astype(np.float32)
    b = rng.integers(-3, 4, size=(5, 8, 8)).astype(np.float32)
    a[rng.random(a.shape) < 0.4] = t.zero
    b[rng.random(b.shape) < 0.4] = t.zero
    T, J = torch.from_numpy, jnp.asarray
    prods = t.matmul(T(a), T(b)).numpy()
    assert np.array_equal(prods, np.asarray(r.jnp_matmul(J(a), J(b))))
    assert np.array_equal(t.add(T(a), T(b)).numpy(),
                          np.asarray(r.jnp_add(J(a), J(b))))
    assert np.array_equal(
        t.tile_combine(T(a[0]), T(a[1]), T(b[2])).numpy(),
        np.asarray(r.jnp_tile_combine(J(a[0]), J(a[1]), J(b[2]))))
    seg = np.array([0, 0, 2, 2, 2])
    got = t.segment_reduce(T(prods), T(seg), 4).numpy()
    want = np.asarray(r.jnp_segment_reduce(J(prods), J(seg), 4))
    assert np.array_equal(got[[0, 2]], want[[0, 2]])
    assert np.all(got[[1, 3]] == t.zero)


# ---------------------------------------------------------------------------
# the rest of the substrate: constructors, permutations, spadd, the 2D/3D
# volume models, the host SUMMA / Split-3D / outer-product oracles, the
# partitioner, validate_blocksparse and the semiring's axis reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tol", [0.0, 0.7])
def test_dense_constructors_array_equal(tol):
    dense = np.random.default_rng(14).standard_normal((23, 17))
    dense[np.abs(dense) < 0.5] = 0.0
    _same_csc(tsp.from_dense(dense, tol), rsp.from_dense(dense, tol))
    for dtype in (np.float64, np.float32):
        _same_csc(tsp.identity(9, dtype), rsp.identity(9, dtype))


def test_csc_allclose_matches_reference():
    r = rsp.erdos_renyi(30, 20, 3.0, seed=15)
    near = rsp.CSC(r.indptr, r.indices, r.data * (1 + 1e-7), r.shape)
    far = rsp.CSC(r.indptr, r.indices, r.data + 1e-3, r.shape)
    t = _port(r)
    for other in (r, near, far, rsp.erdos_renyi(30, 21, 3.0, seed=15)):
        for kw in ({}, {"rtol": 1e-9, "atol": 0.0}, {"atol": 1e-2}):
            assert t.allclose(_port(other), **kw) == r.allclose(other, **kw)


@pytest.mark.parametrize("seed", [0, 5])
def test_block_diagonal_noise_and_restriction_array_equal(seed):
    args = (120, 6, 4.0, 0.5)
    r = rsp.block_diagonal_noise(*args, seed=seed)
    _same_csc(tsp.block_diagonal_noise(*args, seed=seed), r)
    for coarsening in (4, 10, 1000):
        _same_csc(tsp.restriction_operator(_port(r), coarsening, seed=seed),
                  rsp.restriction_operator(r, coarsening, seed=seed))


def test_permutations_array_equal():
    r = rsp.erdos_renyi(40, 40, 3.0, seed=16)
    perm = np.random.default_rng(16).permutation(40)
    t = _port(r)
    _same_csc(tsp.permute_symmetric(t, perm), rsp.permute_symmetric(r, perm))
    _same_csc(tsp.permute_cols(t, perm), rsp.permute_cols(r, perm))
    _same_csc(tsp.permute_rows(t, perm), rsp.permute_rows(r, perm))


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_spadd_and_structure_array_equal(srname):
    ra = rsp.erdos_renyi(50, 40, 3.0, seed=17)
    rb_ = rsp.erdos_renyi(50, 40, 3.0, seed=18)
    neg = rsp.CSC(ra.indptr, ra.indices, -ra.data, ra.shape)   # cancels
    for x, y in ((ra, rb_), (ra, neg), (ra, rsp.from_dense(np.zeros((50,
                                                                     40))))):
        _same_csc(tls.spadd(_port(x), _port(y), tsr.by_name(srname)),
                  rls.spadd(x, y, rsr.by_name(srname)))
    sq = rsp.banded_clustered(40, 5, 3.0, seed=19)
    _same_csc(tls.spgemm_structure(_port(sq), _port(sq)),
              rls.spgemm_structure(sq, sq))


@pytest.mark.parametrize("nparts", [1, 3, 8])
def test_partition_by_weight_and_cv_over_mema_equal(nparts):
    w = np.random.default_rng(nparts).integers(0, 9, size=50) ** 2
    w[10:20] = 0
    assert np.array_equal(tplan.Partition1D.by_weight(w, nparts).splits,
                          rplan.Partition1D.by_weight(w, nparts).splits)
    ra = rsp.erdos_renyi(64, 64, 3.0, seed=20)
    rb_ = rsp.banded_clustered(64, 8, 3.0, seed=21)
    for nblocks in (1, 4, 2048):
        assert tplan.cv_over_mema(_port(ra), _port(rb_), nparts, nblocks) \
            == rplan.cv_over_mema(ra, rb_, nparts, nblocks)


@pytest.mark.parametrize("grid,layers", [(1, 1), (2, 1), (3, 2), (2, 3)])
def test_summa_volume_models_equal(grid, layers):
    ra = rsp.erdos_renyi(70, 60, 3.0, seed=22)
    rb_ = rsp.banded_clustered(60, 9, 4.0, seed=23)
    ta, tb = _port(ra), _port(rb_)
    rs, cs = np.array([0, 20, 70]), np.array([0, 7, 33, 60])
    assert np.array_equal(tplan._block_nnz(ta, rs, cs),
                          rplan._block_nnz(ra, rs, cs))
    splits = [None, dict(row_splits=np.linspace(0, 70, grid + 1) // 2 * 2,
                         colk_splits=np.linspace(0, 60, grid + 1) // 3 * 3,
                         coln_splits=np.linspace(0, 60, grid + 1) // 4 * 4)]
    for kw in splits:
        kw = kw or {}
        t, r = (mod.summa2d_comm_volume(x, y, grid, **kw)
                for mod, x, y in ((tplan, ta, tb), (rplan, ra, rb_)))
        assert set(t) == set(r)
        for k in r:
            assert np.array_equal(t[k], r[k]), k
    assert tplan.summa3d_comm_volume(ta, tb, grid, layers) \
        == rplan.summa3d_comm_volume(ra, rb_, grid, layers)


def test_comm_model_equal():
    for kw in ({}, dict(bandwidth=1e9, latency=1e-5)):
        t, r = tplan.CommModel(**kw), rplan.CommModel(**kw)
        assert t.time(3e6, 17) == r.time(3e6, 17)
        for frac in (0.0, 0.4, 1.0):
            assert t.pipelined_time(3e6, 17, 2e-3, frac) \
                == r.pipelined_time(3e6, 17, 2e-3, frac)


@pytest.mark.parametrize("srname", SEMIRINGS)
@pytest.mark.parametrize("grid,layers", [(1, 1), (2, 1), (3, 1), (2, 2)])
def test_host_summa_oracles_array_equal(srname, grid, layers):
    ra = rsp.banded_clustered(45, 6, 3.0, seed=24)
    rb_ = rsp.erdos_renyi(45, 38, 2.0, seed=25)
    ta, tb = _port(ra), _port(rb_)
    sr_t, sr_r = tsr.by_name(srname), rsr.by_name(srname)
    if layers == 1:
        t, r = t_spgemm_2d(ta, tb, grid, sr_t), r_spgemm_2d(ra, rb_, grid,
                                                            sr_r)
        assert np.array_equal(t.per_process_bytes, r.per_process_bytes)
        assert np.array_equal(t.per_process_flops, r.per_process_flops)
    else:
        t = t_spgemm_3d(ta, tb, grid, layers, sr_t)
        r = r_spgemm_3d(ra, rb_, grid, layers, sr_r)
        assert t.comm_bytes_merge == r.comm_bytes_merge
    _same_csc(t.c, r.c)
    assert (t.comm_bytes_total, t.messages) == (r.comm_bytes_total,
                                                r.messages)


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_spgemm_outer_array_equal(srname):
    ra = rsp.erdos_renyi(40, 50, 3.0, seed=26)
    rb_ = rsp.erdos_renyi(50, 30, 2.0, seed=27)
    t = t_spgemm_outer_1d(_port(ra), _port(rb_), 4,
                          semiring=tsr.by_name(srname))
    r = r_spgemm_outer_1d(ra, rb_, 4, semiring=rsr.by_name(srname))
    _same_csc(t.concat(), r.concat())
    assert (t.redistribute_b_bytes, t.merge_c_bytes, t.total_bytes) == \
        (r.redistribute_b_bytes, r.merge_c_bytes, r.total_bytes)
    assert np.array_equal(t.per_process_flops, r.per_process_flops)


@pytest.mark.parametrize("nparts", [2, 4])
def test_partitioner_array_equal(nparts):
    ra = rsp.block_diagonal_noise(160, 4, 4.0, 0.3, seed=28)
    ta = _port(ra)
    t = tpart.multilevel_partition(ta, nparts, seed=1)
    r = rpart.multilevel_partition(ra, nparts, seed=1)
    assert np.array_equal(t.parts, r.parts)
    assert (t.nparts, t.cut, t.weight_imbalance, t.levels) == \
        (r.nparts, r.cut, r.weight_imbalance, r.levels)
    assert tpart.edge_cut(ta, t.parts) == rpart.edge_cut(ra, r.parts)
    assert np.array_equal(tpart.degree_squared_weights(ta),
                          rpart.degree_squared_weights(ra))
    assert np.array_equal(tpart.random_permutation(50, seed=nparts),
                          rpart.random_permutation(50, seed=nparts))
    for extra in (None, nparts + 2):
        tp, ts = tpart.partition_to_permutation(t.parts, extra)
        rp, rs_ = rpart.partition_to_permutation(r.parts, extra)
        assert np.array_equal(tp, rp) and np.array_equal(ts, rs_)


def _bsp(mod, case):
    r = rsp.banded_clustered(40, 5, 3.0, seed=29)
    b = mod.from_csc(r if mod is rbs else _port(r), bs=8)
    if case == "tiles_ndim":
        b.tiles = b.tiles[0]
    elif case == "coords":
        b.tile_rows = b.tile_rows[:-1]
    elif case == "row_bounds":
        b.tile_rows = b.tile_rows.copy()
        b.tile_rows[0] = 99
    elif case == "col_bounds":
        b.tile_cols = b.tile_cols.copy()
        b.tile_cols[-1] = -1
    elif case == "nan":
        b.tiles = b.tiles.copy()
        b.tiles[0, 0, 0] = np.nan
    elif case == "bs":
        b.bs = 0
    elif case == "type":
        return "not a BlockSparse"
    return b


@pytest.mark.parametrize("case", ["ok", "tiles_ndim", "coords", "row_bounds",
                                  "col_bounds", "nan", "bs", "type"])
def test_validate_blocksparse_matches_reference(case):
    def outcome(val, mod):
        try:
            val.validate_blocksparse(_bsp(mod, case), name="x")
        except val.ValidationError as e:
            return str(e)
        return None

    got, want = outcome(tval, tbs), outcome(rval, rbs)
    assert got == want
    assert (got is None) == (case == "ok")


@pytest.mark.parametrize("srname", SEMIRINGS)
def test_axis_reduce_matches_reference_collective(srname):
    """The Split-3D merge: the port's reduce over a tensor dim against the
    reference's collective over a named axis (psum / pmax / pmin, run
    under ``jax.vmap`` with that axis name), bitwise on integer values with
    identity entries, also into an ``out`` tensor."""
    t, r = tsr.by_name(srname), rsr.by_name(srname)
    rng = np.random.default_rng(30)
    x = rng.integers(-5, 6, size=(3, 4, 8, 8)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = t.zero
    want = np.asarray(jax.vmap(lambda v: r.jnp_axis_reduce(v, "l"),
                               axis_name="l")(jnp.asarray(x)))[0]
    got = t.axis_reduce(torch.from_numpy(x), 0)
    assert np.array_equal(got.numpy(), want)
    out = torch.empty(4, 8, 8)
    t.axis_reduce(torch.from_numpy(x), 0, out=out)
    assert np.array_equal(out.numpy(), want)
