"""The port's launch layer against the reference's, with no processes:
``launch/roofline.py``, ``launch/report.py`` and ``launch/specs.py``.

* ``model_flops`` and ``bytes_model``: equal for every architecture ×
  shape (and a few ``tp`` / batch-shard / chip counts);
* ``Roofline.row()``: every field equal with the reference's ``HW`` held
  equal (the port's is the H100's, so only its time terms and roofline
  fraction differ otherwise); ``collective_bytes`` builds the reference's
  breakdown from a comm's counts;
* ``report``: the same text from the same records;
* ``batch_specs``, ``cache_specs`` and ``state_specs``: the global shapes,
  dtypes and spec tuples of every leaf against the reference's
  ``ShapeDtypeStruct``s and ``PartitionSpec``s (the reference's leading
  stacked-period dim stripped; its specs resolved on a
  ``jax.sharding.AbstractMesh``, the port's on a stand-in mesh), for every
  architecture, each shape kind, both production meshes and each profile;
  each leaf's local tensor holds no memory and has the rank's slice
  shape, and ``state_specs`` matches ``init_train_state`` on the sharded
  init leaf for leaf.
"""

import dataclasses
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.launch.report as rreport
import repro.launch.roofline as rroof
import repro.launch.specs as rspecs
import repro.sharding.rules as rrules
from repro.configs import get_config as r_get_config
from repro.configs.base import SHAPES as R_SHAPES
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.configs.base import SHAPES
from repro_torch.checkpoint.store import _leaves
from repro_torch.core.collectives import KINDS
from repro_torch.launch import report, roofline, specs
from repro_torch.launch.dryrun import DryMesh
from repro_torch.sharding import ShardingRules
from repro_torch.sharding.placement import init_params_sharded
from repro_torch.train import init_train_state

ARCHS = list_archs()
PROFILES = ("default", "dp_only", "serve_tp", "ep_sharded", "ep_dp")
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
KINDS_OF_SHAPE = ("train_4k", "prefill_32k", "decode_32k")


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_bytes_model_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    for name in SHAPES:
        shape, rshape = SHAPES[name], R_SHAPES[name]
        assert roofline.model_flops(cfg, shape) == \
            rroof.model_flops(rcfg, rshape)
        for tp, bsh, chips in ((16, 16, 256), (1, 256, 256), (16, 32, 512),
                               (4, 3, 12)):
            assert roofline.bytes_model(
                cfg, shape, tp=tp, batch_shards=bsh, chips=chips) == \
                rroof.bytes_model(rcfg, rshape, tp=tp, batch_shards=bsh,
                                  chips=chips)


def _counts():
    rng = np.random.default_rng(3)
    sent = {k: int(rng.integers(0, 1 << 30)) for k in KINDS}
    received = {k: int(rng.integers(0, 1 << 30)) for k in KINDS}
    return {"sent": sent, "received": received,
            "calls": {k: int(rng.integers(0, 50)) for k in KINDS}}


def test_roofline_row_and_collective_bytes(monkeypatch):
    counts = _counts()
    coll = roofline.collective_bytes(counts)
    assert set(coll) == set(KINDS) | {"count", "total"}
    assert all(coll[k] == max(counts["sent"][k], counts["received"][k])
               for k in KINDS)
    assert coll["count"] == sum(counts["calls"].values())
    assert coll["total"] == sum(coll[k] for k in KINDS)
    assert roofline.HW == {"peak_flops": 989.4e12, "hbm_bw": 3.35e12,
                           "ici_bw": 50e9}
    cfg, shape = get_config("qwen3-8b"), SHAPES["train_4k"]
    kw = dict(arch="qwen3-8b", shape="train_4k", mesh="16x16", chips=256,
              flops_per_device=3.1e15, bytes_per_device=2.2e11,
              coll_bytes_per_device=float(coll["total"]),
              coll_breakdown=coll, t_compute=0.31, t_memory=0.07,
              t_collective=0.12,
              model_flops=roofline.model_flops(cfg, shape),
              peak_memory_bytes=7.5e10, bytes_hlo=9e12)
    mine, ref = roofline.Roofline(**kw), rroof.Roofline(**kw)
    assert mine.row() != ref.row()      # the H100's peak in the fraction
    monkeypatch.setattr(roofline, "PEAK_FLOPS", rroof.PEAK_FLOPS)
    assert mine.row() == ref.row()
    for t in ("t_compute", "t_memory", "t_collective"):
        # each term dominant in turn
        over = {**kw, t: 1.0}
        assert roofline.Roofline(**over).row() == \
            rroof.Roofline(**over).row()
    # analyze: the counted bytes and the comm's breakdown at the H100's
    # rates
    monkeypatch.undo()
    cost = {"flops": 2e12, "bytes accessed": 5e9, "peak": 1e9, **counts}
    rf = roofline.analyze(cost, cfg, shape, "16x16", 256, "qwen3-8b")
    assert rf.coll_breakdown == coll
    assert rf.t_compute == 2e12 / 989.4e12
    assert rf.t_memory == 5e9 / 3.35e12
    assert rf.t_collective == coll["total"] / 50e9


def _records():
    base = {"arch": "qwen3-8b", "shape": "train_4k", "chips": 256,
            "flops_dev": 3.2e15, "bytes_dev": 2.1e11,
            "bytes_hlo_dev": 9.7e12, "coll_dev": 3.3e9,
            "t_compute_ms": 3234.2, "t_memory_ms": 62.7,
            "t_collective_ms": 66.1, "dominant": "compute",
            "model_flops": 4.7e17, "useful_ratio": 0.58,
            "roofline_frac": 0.52, "peak_memory_gb": 61.3}
    return [
        {"status": "ok", **base, "mesh": "16x16"},
        {"status": "ok", **base, "mesh": "2x16x16", "chips": 512,
         "flops_dev": 7.1e8, "coll_dev": 1.5e6, "peak_memory_gb": 0.41,
         "dominant": "collective"},
        {"status": "ok", **base, "shape": "decode_32k", "mesh": "16x16",
         "flops_dev": 4.4e9, "dominant": "memory"},
        {"arch": "qwen3-8b", "shape": "long_500k", "mesh": "16x16",
         "status": "skipped", "reason": "full-attention arch; long_500k "
         "needs sub-quadratic mixing (DESIGN.md §5)"},
        {"arch": "jamba-v0.1-52b", "shape": "long_500k", "mesh": "16x16",
         "status": "FAILED", "error": "NotImplementedError('a global "
         "batch of 1 over 16 ranks would be replicated')"}]


def test_report_renders_the_reference_text(capsys):
    recs = _records()
    assert report.dryrun_table(recs) == rreport.dryrun_table(recs)
    for mesh in ("16x16", "2x16x16"):
        assert report.roofline_table(recs, mesh) == \
            rreport.roofline_table(recs, mesh)
    with tempfile.TemporaryDirectory() as d:
        for i, r in enumerate(recs):
            with open(os.path.join(d, f"{i}.json"), "w") as f:
                json.dump(r, f)
        assert report.load(d) == rreport.load(d)
        assert report.main(["--dir", d]) == rreport.main(["--dir", d]) == 0
    out = capsys.readouterr()
    half = len(out.out) // 2
    assert out.out[:half] == out.out[half:]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _key(path) -> str:
    parts = []
    for k in path:
        for attr in ("name", "key", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def _pad(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _ref_leaves(tree):
    """{path: (shape, dtype name, spec tuple)} of a ShapeDtypeStruct tree."""
    return {_key(p): (tuple(s.shape), str(s.dtype),
                      _pad(s.sharding.spec, len(s.shape)))
            for p, s in jax.tree_util.tree_leaves_with_path(tree)}


def _mine(leaf):
    return (leaf.shape, str(leaf.dtype).replace("torch.", ""), leaf.spec)


def _port_key(path, plen):
    """The reference's stacked path of a port leaf path and its layer's
    period: ``.../layers/<l>/x`` -> (``.../period/pos<l % plen>/x``,
    ``l // plen``)."""
    parts = path.split("/")
    if "layers" not in parts:
        return path, None
    i = parts.index("layers")
    layer = int(parts[i + 1])
    parts[i:i + 2] = ["period", f"pos{layer % plen}"]
    return "/".join(parts), layer // plen


def _check_tree(port_tree, ref_tree, plen, stacked_paths=True):
    ref = _ref_leaves(ref_tree)
    seen = set()
    for path, leaf in _leaves(port_tree):
        if not isinstance(leaf, specs.Leaf):
            continue
        rpath, period = _port_key(path, plen) if stacked_paths \
            else (path, None)
        shape, dtype, spec = ref[rpath]
        if period is not None:
            shape, spec = shape[1:], spec[1:]
        assert _mine(leaf) == (shape, dtype, spec), path
        local = tuple(leaf.tensor.shape)
        assert leaf.tensor.device.type == "meta"
        assert len(local) == len(shape)
        seen.add(rpath)
    assert seen == set(ref), set(ref) ^ seen


def _combos():
    """(arch, mesh, profile): every arch, both meshes and every profile."""
    return [(arch, MESHES[i % 2], PROFILES[i % len(PROFILES)])
            for i, arch in enumerate(ARCHS)]


@pytest.mark.parametrize("arch,mesh,profile", _combos())
def test_specs_equal_the_reference(arch, mesh, profile):
    (shape, names) = mesh
    amesh = AbstractMesh(shape, names)
    rrules_ = rrules.ShardingRules.for_mesh(amesh, profile)
    dmesh = DryMesh(shape, names)
    rules = ShardingRules.for_mesh(dmesh, profile)
    cfg, rcfg = get_config(arch), r_get_config(arch)
    plen = len(cfg.pattern)

    rstate, _ = rspecs.state_specs(rcfg, amesh, rrules_)
    _check_tree(specs.state_specs(cfg, dmesh, rules), rstate, plen)
    rparams, _ = rspecs.state_specs(rcfg, amesh, rrules_, with_opt=False)
    _check_tree(specs.state_specs(cfg, dmesh, rules, with_opt=False),
                rparams, plen)
    for name in KINDS_OF_SHAPE:
        s, rs = SHAPES[name], R_SHAPES[name]
        _check_tree(specs.batch_specs(cfg, s, dmesh, rules),
                    rspecs.batch_specs(rcfg, rs, amesh, rrules_), plen,
                    stacked_paths=False)
        if name == "decode_32k":
            caches = specs.cache_specs(cfg, s, dmesh, rules)
            rc = _ref_leaves(rspecs.cache_specs(rcfg, rs, amesh, rrules_))
            for layer, c in enumerate(caches):
                for field in ("k", "v") if hasattr(c, "length") \
                        else ("conv", "ssm"):
                    shape_, dtype, spec = rc[f"pos{layer % plen}/{field}"]
                    leaf = getattr(c, field)
                    assert _mine(leaf) == (shape_[1:], dtype, spec[1:]), \
                        (layer, field)
                if hasattr(c, "length"):
                    assert c.length == 0


def test_specs_local_shapes_match_the_sharded_init():
    """``state_specs``' local tensors (compress included) are
    ``init_train_state``'s on ``init_params_sharded``'s slices, leaf for
    leaf; ``batch_specs`` is ``batch_slab``'s slab."""
    from repro_torch.sharding.placement import batch_slab

    for arch, shape, names, profile in (
            ("qwen2-moe-a2.7b", (2, 4), ("data", "model"), "ep_dp"),
            ("jamba-v0.1-52b", (1, 4), ("data", "model"), "default"),
            ("gemma2-2b", (2, 2), ("data", "model"), "serve_tp")):
        cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
        rules = ShardingRules.for_mesh(DryMesh(shape, names), profile)
        params = init_params_sharded(cfg, rules, device="cpu",
                                     dtype=torch.float32)
        want = init_train_state(cfg, params, compress=True)
        got = specs.state_specs(cfg, None, rules, compress=True)
        w, g = list(_leaves(want)), list(_leaves(got))
        assert [p for p, _ in w] == [p for p, _ in g]
        for (path, a), (_, b) in zip(w, g):
            assert tuple(a.shape) == tuple(b.tensor.shape), path
            assert a.dtype == b.dtype, path
        s = dataclasses.replace(SHAPES["train_4k"], global_batch=16,
                                seq_len=8)
        for name, leaf in specs.batch_specs(cfg, s, None, rules).items():
            slab = batch_slab(torch.zeros(leaf.shape), rules)
            assert tuple(slab.shape) == tuple(leaf.tensor.shape), name
