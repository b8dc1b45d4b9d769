"""The port's sharding rules against the reference's, with no processes.

``repro_torch.sharding.rules`` and ``repro_torch.launch.specs`` resolve
the reference's five profiles on stand-in meshes that carry only the dim
names and sizes — (1, 4), (2, 4), (16, 16) and (2, 16, 16) — for every
architecture:

* ``param_pspecs`` on the smoke parameters and ``_spec_for`` on the full
  configs' shapes (``jax.eval_shape`` of the reference's ``init_params``,
  the port's tree on the ``meta`` device), the reference's leading
  stacked-period dim stripped: equal specs, leaf by leaf, with the port's
  leaf paths (``layers/<p·len(pattern)+i>/…`` for ``period/pos<i>/…``);
* ``batch_pspecs`` and ``cache_pspecs`` for every shape: equal;
* ``shard`` is the identity; ``check_executable`` passes FSDP over
  ``data > 1`` and the tensor-parallel profiles, mamba blocks included
  (ROADMAP A8d); the meshes and the sharded init refuse what they cannot
  do, and at (1, 4), (2, 4) and (2, 2) the sharded init keeps the spec's
  slices.
"""

import jax
import pytest
import torch

import repro.launch.specs as rspecs
import repro.models as rmodels
import repro.sharding.rules as rrules
from repro.configs import get_config as r_get_config
from repro.configs import list_archs as r_list_archs
from repro.configs import smoke_config as r_smoke_config
from repro.configs.base import SHAPES as R_SHAPES
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.validate import ValidationError
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.sharding import (ShardingRules, check_executable,
                                  leaf_pspecs, shard, use_rules)
from repro_torch.sharding.placement import global_params, init_params_sharded
from repro_torch.checkpoint.store import _leaves as _paths
from repro_torch.sharding.rules import _spec_for

PROFILES = ("default", "dp_only", "serve_tp", "ep_sharded", "ep_dp")
MESHES = {(1, 4): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


class StandInMesh:
    """A mesh's dim names and sizes, for both packages' ``for_mesh``."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.coordinate = {n: 0 for n in names}


def _rules(shape, profile):
    mesh = StandInMesh(shape, MESHES[shape])
    return (rrules.ShardingRules.for_mesh(mesh, profile),
            ShardingRules.for_mesh(mesh, profile))


def _spec(p):
    return tuple(p)


def _port_path(cfg, path):
    """The reference's ``period/pos<i>/rest`` -> (i, rest); other paths
    as they are."""
    parts = path.split("/")
    if parts[0] != "period":
        return None, path
    return int(parts[1][3:]), "/".join(parts[2:])


def _ref_specs(cfg, tree, rules):
    """{port path: spec} of a reference params tree (or shape tree), the
    stacked-period dim stripped and one entry per layer."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        name = "/".join(getattr(k, "key", getattr(k, "name", str(k)))
                        for k in path)
        spec = _spec(rrules._spec_for(name, leaf.shape, rules))
        pos, rest = _port_path(cfg, name)
        if pos is None:
            out[name] = spec
            continue
        assert spec[0] is None
        for p in range(cfg.n_periods):
            out[f"layers/{p * len(cfg.pattern) + pos}/{rest}"] = spec[1:]
    return out


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("arch", r_list_archs())
def test_param_pspecs_match_on_smoke_params(arch, shape):
    rcfg = r_smoke_config(arch)
    rparams = rmodels.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = global_params(smoke_config(arch), torch.float32)
    for profile in PROFILES:
        rr, tr = _rules(shape, profile)
        want = {}
        flat, _ = jax.tree_util.tree_flatten_with_path(
            rrules.param_pspecs(rparams, rr),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for path, p in flat:
            name = "/".join(getattr(k, "key", str(k)) for k in path)
            pos, rest = _port_path(rcfg, name)
            if pos is None:
                want[name] = _spec(p)
            else:
                for per in range(rcfg.n_periods):
                    want[f"layers/{per * len(rcfg.pattern) + pos}/{rest}"] \
                        = _spec(p)[1:]
        got = dict(leaf_pspecs(tparams, tr))
        assert got == want, (arch, shape, profile)


@pytest.mark.parametrize("arch", r_list_archs())
def test_spec_for_matches_on_full_config_shapes(arch):
    rcfg = r_get_config(arch)
    shapes = jax.eval_shape(lambda: rmodels.init_params(
        rcfg, jax.random.PRNGKey(0)))
    tparams = global_params(get_config(arch))
    for shape in MESHES:
        for profile in PROFILES:
            rr, tr = _rules(shape, profile)
            got = {path: _spec_for(path, tuple(leaf.shape), tr)
                   for path, leaf in _paths(tparams)}
            assert got == _ref_specs(rcfg, shapes, rr), \
                (arch, shape, profile)


@pytest.mark.parametrize("arch", r_list_archs())
def test_batch_and_cache_pspecs_match(arch):
    rcfg, tcfg = r_get_config(arch), get_config(arch)
    for shape in MESHES:
        for profile in PROFILES:
            rr, tr = _rules(shape, profile)
            for name in SHAPES:
                rb = rspecs.batch_pspecs(rcfg, R_SHAPES[name], rr)
                tb = tspecs.batch_pspecs(tcfg, SHAPES[name], tr)
                assert {k: _spec(v) for k, v in rb.items()} == tb
                rc = rspecs.cache_pspecs(rcfg, R_SHAPES[name], rr)
                tc = tspecs.cache_pspecs(tcfg, SHAPES[name], tr)
                assert len(tc) == tcfg.n_layers
                for layer, t in enumerate(tc):
                    r = rc[f"pos{layer % len(rcfg.pattern)}"]
                    assert type(t).__name__ == type(r).__name__
                    for field in r._fields:
                        assert getattr(t, field) == \
                            _spec(getattr(r, field))[1:], \
                            (arch, shape, profile, name, layer, field)


def test_for_mesh_resolves_like_the_reference():
    for shape in MESHES:
        for profile in PROFILES:
            rr, tr = _rules(shape, profile)
            for f in ("batch", "fsdp", "tp", "sp", "tp_size", "fsdp_size",
                      "batch_size", "ep_shard_map", "ep_axis"):
                assert getattr(rr, f) == getattr(tr, f), (shape, profile, f)
            assert rr.expert_axis == tr.expert_axis
    with pytest.raises(ValueError, match="unknown profile"):
        ShardingRules.for_mesh(StandInMesh((1, 4), ("data", "model")), "tp")


def test_shard_is_the_identity():
    x = torch.randn(4, 3, 2)
    _, tr = _rules((1, 4), "ep_dp")
    assert shard(x, "batch", None, None) is x
    with use_rules(tr):
        assert shard(x, "batch", "seq_sp", "tp") is x


TP_PROFILES = ("default", "serve_tp", "ep_sharded")


@pytest.mark.parametrize("profile", TP_PROFILES)
def test_tp_profiles_execute(profile):
    """The tensor-parallel profiles (ROADMAP A8c) pass ``check_executable``
    on (1, 4), (2, 4) and the production meshes for every config without
    mamba layers; at (2, 2) every coordinate's sharded init is the spec's
    slices of the one-process ``init_params``: the leaves split over
    ``model`` (attention's and the MLPs' projections, the experts, the
    vocabulary) and, under ``default`` / ``ep_sharded``, over ``data``
    too."""
    from repro_torch.models import init_params
    from repro_torch.sharding.placement import local_slice, spec_axes

    for shape in MESHES:
        _, tr = _rules(shape, profile)
        assert tr.tp == "model"
        for arch in r_list_archs():
            cfg = get_config(arch)
            if not any(k in "mM" for k in cfg.pattern):
                check_executable(tr, cfg)
    cfg = smoke_config("qwen2-moe-a2.7b")
    whole = dict(_paths(init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu",
        dtype=torch.float32)))
    mesh = StandInMesh((2, 2), ("data", "model"))
    for d in range(2):
        for m in range(2):
            mesh.coordinate = {"data": d, "model": m}
            tr = ShardingRules.for_mesh(mesh, profile)
            specs = dict(leaf_pspecs(global_params(cfg), tr))
            got = init_params_sharded(cfg, tr,
                                      torch.Generator().manual_seed(3),
                                      device="cpu", dtype=torch.float32)
            both = 0
            for path, leaf in _paths(got):
                assert torch.equal(leaf, local_slice(whole[path],
                                                     specs[path], tr))
                axes = {a for e in specs[path] for a in spec_axes(e)}
                both += axes == {"data", "model"}
                assert leaf.numel() * (2 if "model" in axes else 1) \
                    * (2 if "data" in axes else 1) == whole[path].numel()
            # embed, and a layer's wq wk wv wo, shared up gate down
            want = 0 if profile == "serve_tp" else 1 + 7 * cfg.n_layers
            assert both == want, (profile, d, m, both)


@pytest.mark.parametrize("profile", TP_PROFILES)
@pytest.mark.parametrize("arch", ("mamba2-1.3b", "jamba-v0.1-52b"))
def test_mamba_under_tp_executes_with_the_spec_slices(profile, arch):
    """Mamba blocks under a tensor-parallel profile (ROADMAP A8d) pass
    ``check_executable`` on every mesh, and at (1, 4) every coordinate's
    sharded init is the spec's slices of the one-process ``init_params``:
    ``w_in``'s and ``conv_w``'s column blocks and ``w_out``'s rows a
    quarter each, ``a_log``, ``dt_bias``, ``d_skip`` and ``norm``
    whole."""
    from repro_torch.models import init_params
    from repro_torch.sharding.placement import local_slice

    cfg = smoke_config(arch)
    for shape in MESHES:
        check_executable(_rules(shape, profile)[1], get_config(arch))
        check_executable(_rules(shape, profile)[1], cfg)
    whole = dict(_paths(init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu",
        dtype=torch.float32)))
    mesh = StandInMesh((1, 4), ("data", "model"))
    for m in range(4):
        mesh.coordinate = {"data": 0, "model": m}
        tr = ShardingRules.for_mesh(mesh, profile)
        specs = dict(leaf_pspecs(global_params(cfg), tr))
        got = dict(_paths(init_params_sharded(
            cfg, tr, torch.Generator().manual_seed(3), device="cpu",
            dtype=torch.float32)))
        mixers = 0
        for path, leaf in got.items():
            assert torch.equal(leaf, local_slice(whole[path], specs[path],
                                                 tr)), (m, path)
            if "/mamba/" not in path:
                continue
            mixers += 1
            quarter = path.rsplit("/", 1)[1] in ("w_in", "conv_w", "w_out")
            assert leaf.numel() * (4 if quarter else 1) \
                == whole[path].numel(), path
        assert mixers == 7 * sum(k in "mM" for k in cfg.pattern) \
            * cfg.n_periods


@pytest.mark.parametrize("profile,shape", [
    ("ep_dp", (2, 4)), ("dp_only", (16, 16)), ("ep_dp", (2, 16, 16))])
def test_fsdp_profiles_execute(profile, shape):
    """FSDP over ``data > 1`` (ROADMAP A8b) passes ``check_executable``; at
    (2, 4) every coordinate's sharded init is the spec's slices of the
    one-process ``init_params``, each FSDP leaf split over ``data`` on its
    ``fsdp_dim``."""
    from repro_torch.models import init_params
    from repro_torch.sharding import fsdp_dim
    from repro_torch.sharding.placement import local_slice

    _, tr = _rules(shape, profile)
    check_executable(tr)
    assert tr.fsdp == "data" and tr.fsdp_size == shape[-2]
    if shape != (2, 4):
        return
    cfg = smoke_config("qwen2-moe-a2.7b")
    whole = dict(_paths(init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu",
        dtype=torch.float32)))
    mesh = StandInMesh(shape, MESHES[shape])
    for d in range(2):
        for m in range(4):
            mesh.coordinate = {"data": d, "model": m}
            tr = ShardingRules.for_mesh(mesh, profile)
            specs = dict(leaf_pspecs(global_params(cfg), tr))
            got = init_params_sharded(cfg, tr,
                                      torch.Generator().manual_seed(3),
                                      device="cpu", dtype=torch.float32)
            fsdp = 0
            for path, leaf in _paths(got):
                assert torch.equal(leaf, local_slice(whole[path],
                                                     specs[path], tr))
                dim = fsdp_dim(specs[path], tr)
                if dim is not None:
                    fsdp += 1
                    assert leaf.shape[dim] * 2 == whole[path].shape[dim]
            # embed, and a layer's wq wk wv wo, router, shared up gate down
            assert fsdp == 1 + 8 * cfg.n_layers, (d, m, fsdp)


def test_executed_profiles_pass_and_need_a_card_by_default():
    for profile in ("ep_dp", "dp_only"):
        _, tr = _rules((1, 4), profile)
        check_executable(tr)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                init_params_sharded(smoke_config("qwen2-moe-a2.7b"), tr)


def test_meshes_need_a_world():
    with pytest.raises(ValidationError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValidationError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValidationError, match="8 ranks"):
        make_local_mesh(2, 4)


def test_sharded_init_keeps_the_one_process_slices():
    """Every (1, 4) coordinate's slices, from the same generator seed, are
    the slices of the one-process ``init_params``."""
    from repro_torch.models import init_params
    from repro_torch.sharding.placement import local_slice

    cfg = smoke_config("qwen2-moe-a2.7b")
    whole = dict(_paths(init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu",
        dtype=torch.float32)))
    mesh = StandInMesh((1, 4), ("data", "model"))
    for m in range(4):
        mesh.coordinate = {"data": 0, "model": m}
        tr = ShardingRules.for_mesh(mesh, "ep_dp")
        got = init_params_sharded(cfg, tr, torch.Generator().manual_seed(3),
                                  device="cpu", dtype=torch.float32)
        specs = dict(leaf_pspecs(global_params(cfg), tr))
        split = 0
        for path, leaf in _paths(got):
            want = local_slice(whole[path], specs[path], tr)
            split += want.shape != whole[path].shape
            assert torch.equal(leaf, want), (m, path)
            assert leaf.untyped_storage().nbytes() == \
                leaf.numel() * leaf.element_size(), path
        assert split == 1 + 3 * cfg.n_layers   # embed + the expert leaves
