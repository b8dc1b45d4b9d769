"""The port's host substrate against the reference's, on the same inputs.

Generators, blockization, product schedules, visit flags, partitions, the
fetch plan and the host oracles are plain numpy in both packages, so the
port's outputs must be array-equal to ``repro.core.*`` (tolerance: none —
exact equality of every array and scalar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.blocksparse as rbs
import repro.core.local_spgemm as rls
import repro.core.plan as rplan
import repro.core.semiring as rsr
import repro.core.sparse as rsp
import repro_torch.core.blocksparse as tbs
import repro_torch.core.local_spgemm as tls
import repro_torch.core.plan as tplan
import repro_torch.core.semiring as tsr
import repro_torch.core.sparse as tsp
from repro.core.spgemm_1d import spgemm_1d as r_spgemm_1d
from repro_torch.core.convert import csc_from_arrays
from repro_torch.core.spgemm_1d import spgemm_1d as t_spgemm_1d

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
