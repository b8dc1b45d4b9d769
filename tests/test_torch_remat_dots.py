"""Remat ``"dots"`` in the port (``models/transformer.py::_train_stack``)
on the CPU.

* The loss and every gradient under ``"dots"`` are bitwise ``"block"``'s
  and ``"none"``'s (qwen2-moe, gemma2 and jamba's smoke configs, one
  period for jamba: attention, MoE, windowed and mamba layers).
* Against the reference's ``loss_fn`` at ``remat="dots"``
  (``save_from_both_policies`` of the no-batch-dim dots and the MoE
  all-to-all's names; the plain versions, ``use_kernel=False``): the
  metrics within rtol 1e-5 and every leaf's gradient within 1e-5 of the
  leaf's largest magnitude, the bounds of ``tests/test_torch_train.py``.
* What is kept: in a training step's backward, ``"dots"`` recomputes no
  ``aten.mm`` (the step runs as many as ``"none"``'s) while ``"block"``
  recomputes every one; the batched products are recomputed under both.
  The policy saves ``aten.mm``, ``aten.addmm`` and the MoE dispatch's two
  exchanges (``collectives.all_to_all`` of kind ``"a2a"`` and
  ``collectives.EXCHANGE``; across ranks: ``tests/test_torch_dryrun.py``),
  and recomputes an all-to-all of another kind.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models as rmodels
from repro.configs import smoke_config as r_smoke_config
from repro.data import SyntheticLMDataset as RDataset
from repro_torch.configs import smoke_config
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.core.collectives import ALL_TO_ALL, EXCHANGE
from repro_torch.models import init_params, params_from_reference
from repro_torch.models.transformer import DOTS_SAVED, _dots_policy
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import _grads

ARCHS = ("qwen2-moe-a2.7b", "gemma2-2b", "jamba-v0.1-52b")


def _cfg(arch, remat):
    cfg = dataclasses.replace(smoke_config(arch), remat=remat)
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    return cfg


def _data(cfg, seq=64, batch=2):
    return RDataset(cfg.vocab, seq, batch, seed=1, input_kind=cfg.input_kind,
                    d_model=cfg.d_model).batch(0)


def _inputs(arch):
    """(port float32 params from a seeded generator, numpy batch)."""
    cfg = _cfg(arch, "none")
    return init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32), _data(cfg)


def _batch(b):
    return {k: torch.from_numpy(v).long() if k != "embeds"
            else torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_is_bitwise_block_and_none(arch):
    tp, b = _inputs(arch)
    got = {r: _grads(_cfg(arch, r), tp, _batch(b))
           for r in ("none", "block", "dots")}
    g0, m0 = got["none"]
    for r in ("block", "dots"):
        g, m = got[r]
        assert all(torch.equal(m0[k], m[k]) for k in m0), r
        assert all(torch.equal(a, c) for a, c in zip(g0, g)), r


def test_dots_matches_the_reference():
    arch = "qwen2-moe-a2.7b"
    rcfg = dataclasses.replace(r_smoke_config(arch), remat="dots")
    rp = jax.jit(rmodels.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(0))
    b = _data(rcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), rcfg,
                               device="cpu")
    (_, rmet), rg = jax.jit(
        jax.value_and_grad(rmodels.loss_fn, has_aux=True),
        static_argnums=1, static_argnames="use_kernel")(
            rp, rcfg, {k: jnp.asarray(v) for k, v in b.items()},
            use_kernel=False)
    grads, met = _grads(_cfg(arch, "dots"), tp, _batch(b))
    for k in rmet:
        np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                   rtol=1e-5, atol=1e-7)
    want = tree_leaves(params_from_reference(jax.tree.map(np.asarray, rg),
                                             rcfg, device="cpu"))
    assert len(grads) == len(want)
    for a, w in zip(grads, want):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-5 * scale + 1e-12


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen[func] += 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_products_with_no_batch_dims():
    assert DOTS_SAVED == {torch.ops.aten.mm.default,
                          torch.ops.aten.addmm.default, EXCHANGE}
    x = torch.zeros(4)
    for kind, want in (("a2a", CheckpointPolicy.MUST_SAVE),
                       ("vocab", CheckpointPolicy.PREFER_RECOMPUTE)):
        assert _dots_policy(None, ALL_TO_ALL, x, 0, "data", 0, 0,
                            kind) == want
    tp, b = _inputs("gemma2-2b")
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    seen = {}
    for r in ("none", "block", "dots"):
        with _Ops() as ops:
            _grads(_cfg("gemma2-2b", r), tp, _batch(b))
        seen[r] = ops.seen
    assert seen["dots"][mm] == seen["none"][mm] < seen["block"][mm]
    assert seen["dots"][bmm] == seen["block"][bmm] > seen["none"][bmm]
