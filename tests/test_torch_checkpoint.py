"""The port's checkpoint store and loop snapshots against the reference's.

Pins the store's contract on the CPU (an atomic step directory with no
``tmp.`` left behind, keep-last-k GC, async save then ``wait``, restore
onto a device with the template's dtype and a shape mismatch refused), the
loop checkpointer's cadence and empty-directory resume, CSC packing that
keeps dtypes bit for bit, and the on-disk format across the two packages:
a snapshot written by either loads in the other with equal arrays and
equal ``meta.json`` keys. Every comparison is exact (tolerance: none).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.runtime import LoopCheckpointer as RLoopCheckpointer
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core import CSC, erdos_renyi
from repro_torch.runtime import (LoopCheckpointer, pack_csc, pack_csc_list,
                                 unpack_csc, unpack_csc_list)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(
                rng.standard_normal((8, 8)).astype(np.float32)),
            "nested": {"b": np.arange(5), "c": torch.tensor(1.5)},
            "seq": [np.int32(3), (torch.arange(4, dtype=torch.int16),
                                  np.ones((2, 3), dtype=np.float64))]}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _meta(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def test_roundtrip_keeps_values_dtypes_and_leaf_kinds(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    restored = restore_checkpoint(str(tmp_path), t)
    assert isinstance(restored["seq"], list)
    assert isinstance(restored["seq"][1], tuple)
    for want, got in zip(_leaves(t), _leaves(restored)):
        assert isinstance(got, torch.Tensor) == isinstance(want,
                                                           torch.Tensor)
        assert _np(got).dtype == _np(want).dtype
        np.testing.assert_array_equal(_np(got), _np(want))
    # the reference's key scheme: dict keys sorted, sequence indices
    assert _meta(str(tmp_path), 7)["keys"] == [
        "a", "nested/b", "nested/c", "seq/0", "seq/1/0", "seq/1/1"]


def test_atomicity_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    save_checkpoint(str(tmp_path), 1, _tree(1))    # overwrites in place
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]
    assert os.listdir(tmp_path) == ["step_00000001"]


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]


def test_async_save_then_wait_writes_the_values_at_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree()
    want = t["a"].clone()
    mgr.save(5, t)
    t["a"].add_(1.0)          # an in-place update after save returns
    mgr.wait()
    assert latest_step(str(tmp_path)) == 5
    got = mgr.restore(_tree())
    assert torch.equal(got["a"], want)


def test_async_save_failure_raises_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker), async_save=True)
    mgr.save(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                # the error is raised once


def test_restore_casts_to_the_template_dtype_on_the_device(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 2, t)
    like = {"a": torch.zeros(8, 8, dtype=torch.float64),
            "nested": {"b": np.zeros(5, dtype=np.float32),
                       "c": torch.zeros((), dtype=torch.float16)},
            "seq": [np.int64(0), (torch.zeros(4, dtype=torch.int64),
                                  np.zeros((2, 3), dtype=np.float32))]}
    got = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert got["a"].dtype == torch.float64 and got["a"].device.type == "cpu"
    assert torch.equal(got["a"], t["a"].double())
    assert isinstance(got["nested"]["b"], np.ndarray)
    assert got["nested"]["b"].dtype == np.float32
    assert got["nested"]["c"].dtype == torch.float16
    assert got["seq"][0].dtype == np.int64 and got["seq"][0] == 3
    assert got["seq"][1][0].dtype == torch.int64


def test_restore_refuses_a_shape_mismatch(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    bad = dict(t, a=torch.zeros(4, 8))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), bad)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), t)


# ---------------------------------------------------------------------------
# loop snapshots
# ---------------------------------------------------------------------------

def test_loop_checkpointer_cadence_and_empty_resume(tmp_path):
    ck = LoopCheckpointer(str(tmp_path / "loop"), keep=10, every=3)
    assert ck.resume() == (None, None)
    saved = [s for s in range(1, 8)
             if ck.maybe_save(s, {"x": np.asarray(s)})]
    assert saved == [3, 6]
    step, state = ck.resume()
    assert step == 6 and int(state["x"]) == 6
    with pytest.raises(ValueError):
        LoopCheckpointer(str(tmp_path), every=0)


def _csc(dtype, seed):
    m = erdos_renyi(30, 17, 3.0, seed=seed)
    return CSC(m.indptr.astype(np.int32), m.indices.astype(np.int32),
               m.data.astype(dtype), m.shape)


def _same_csc(a, b):
    assert a.shape == b.shape
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices),
                 (a.data, b.data)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_pack_csc_keeps_dtypes_bit_for_bit(tmp_path, dtype):
    mats = [_csc(dtype, s) for s in range(3)]
    state = {}
    pack_csc("m", mats[0], state)
    pack_csc_list("levels", mats, state)
    _same_csc(unpack_csc("m", state), mats[0])
    ck = LoopCheckpointer(str(tmp_path))
    ck.maybe_save(1, state)
    _, back = ck.resume()
    _same_csc(unpack_csc("m", back), mats[0])
    for got, want in zip(unpack_csc_list("levels", back), mats):
        _same_csc(got, want)
    assert len(unpack_csc_list("levels", back)) == 3


def _loop_state(seed):
    m = _csc(np.float64, seed)
    state = {"it": np.asarray(4, dtype=np.int64),
             "chaos": np.asarray(0.25, dtype=np.float64)}
    pack_csc("m", m, state)
    return state


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshots_cross_between_packages(tmp_path, writer):
    """A snapshot written by either package's ``LoopCheckpointer`` loads in
    the other's ``resume()`` with equal arrays, and the two packages write
    the same ``meta.json`` keys, shapes and dtypes."""
    state = _loop_state(5)
    mine, theirs = str(tmp_path / "a"), str(tmp_path / "b")
    write, read = ((RLoopCheckpointer, LoopCheckpointer)
                   if writer == "reference"
                   else (LoopCheckpointer, RLoopCheckpointer))
    write(mine).maybe_save(4, state)
    step, got = read(mine).resume()
    assert step == 4 and set(got) == set(state)
    for k, v in state.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    read(theirs).maybe_save(4, state)
    assert _meta(mine, 4) == _meta(theirs, 4)


def test_trees_cross_between_packages(tmp_path):
    """``save_checkpoint`` trees: the port restores a reference snapshot
    and the reference restores the port's."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = np.arange(6, dtype=np.int32)
    r_save(str(tmp_path / "ref"), 1, {"w": jnp.asarray(a),
                                      "s": [jnp.asarray(b)]})
    got = restore_checkpoint(str(tmp_path / "ref"),
                             {"w": torch.zeros(3, 4), "s": [np.zeros(6,
                                                                 np.int32)]})
    assert np.array_equal(got["w"].numpy(), a)
    assert np.array_equal(got["s"][0], b)
    save_checkpoint(str(tmp_path / "port"), 1, {"w": torch.from_numpy(a),
                                                "s": [b]})
    back = r_restore(str(tmp_path / "port"), {"w": jnp.zeros((3, 4)),
                                              "s": [jnp.zeros(6, jnp.int32)]})
    assert np.array_equal(np.asarray(back["w"]), a)
    assert np.array_equal(np.asarray(back["s"][0]), b)
    assert _meta(str(tmp_path / "ref"), 1) == _meta(str(tmp_path / "port"),
                                                     1)
