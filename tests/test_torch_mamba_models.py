"""The port's mamba block kinds ('m', 'M') through the whole model against
the reference, on the CPU: serving (prefill, decode, ``generate``),
training (``loss_fn`` and its gradient, one AdamW step) and both launchers.

Two archs: mamba2-1.3b's smoke config (2 pure mamba layers, d_ff 0) and
jamba-v0.1-52b's cut to one period, 8 of its 16 layers (``m M m M a M m
M``: mamba, MoE, the attention layer; the second period repeats the
first, and the file must stay short), with the MoE capacity raised to 16
so that an S-token prefill and a 1-token decode drop no token (the drop
policy differs between the two; the numerics are what is held). The
reference's weights reach the port through ``params_from_reference``; the
reference runs its plain path (``use_kernel=False``) under ``jax.jit``,
the port its plain versions on CPU tensors. Token inputs come from numpy
seeds.

Tolerances (float32 smoke configs): prefill logits within 1e-5 of the
largest logit. A decode step after the port's prefill against the
reference's prefill over the longer sequence: 1e-5 at mamba2 (float32
throughout), 2e-3 at jamba, whose attention layer decodes against the
bf16 KV cache (one bf16 rounding of k and v, 2^-9 relative). ``generate``'s
greedy tokens equal the argmax of the reference's prefill over the
growing sequence. The loss within 1e-5 relative, every gradient leaf
within 1e-5 of its largest magnitude (finite: ``_segsum``'s -inf is in
the graph). One AdamW step (lr 1e-4): every parameter within 1e-4 of its
leaf's largest magnitude, as ``test_torch_train.py`` argues for three.

The reference's own ``generate`` is not the oracle: its prefill leaves
every mamba state at zero (``test_torch_mamba.py`` pins that), so it
decodes as if the prompt had reached the attention layers only.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
from repro.configs import smoke_config as r_smoke_config
from repro.data import SyntheticLMDataset as RDataset
from repro.train import AdamWConfig as RAdamWConfig
from repro.train import init_train_state as r_init_train_state
from repro.train.optimizer import adamw_update as r_adamw_update
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import (decode_step, init_caches, init_params,
                                loss_fn, params_from_reference, prefill_step,
                                train_state_from_reference)
from repro_torch.models.blocks import block_apply, block_cache_init
from repro_torch.models.mamba2 import SSMState
from repro_torch.models.transformer import layer_kinds
from repro_torch.serve import ServeEngine
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import _grads

ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b")
# the decode step's tolerance, relative to the largest logit (docstring)
DECODE_REL = {"mamba2-1.3b": 1e-5, "jamba-v0.1-52b": 2e-3}


def _cut(cfg):
    if cfg.name.startswith("jamba"):
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(reference cfg, reference params, port cfg, port params, jitted
    reference prefill)."""
    cfg, tcfg = _cut(r_smoke_config(arch)), _cut(smoke_config(arch))
    rp = rmodels.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                               device="cpu")
    prefill = jax.jit(functools.partial(rmodels.prefill_step, cfg=cfg,
                                        use_kernel=False))

    def r_prefill(toks):
        logits, _ = prefill(rp, batch={"tokens": jnp.asarray(toks)},
                            caches=rmodels.init_caches(cfg, toks.shape[0],
                                                       toks.shape[1]))
        return np.asarray(logits)

    return cfg, rp, tcfg, tp, r_prefill


def _rel_close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + 1e-12, (err, scale)


def _tokens(cfg, s, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (2, s))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_leaf_by_leaf(arch):
    """Every reference leaf lands bitwise in its layer, the seven mamba
    leaves included; the port's own init makes the same tree."""
    cfg, rp, tcfg, tp, _ = _models(arch)
    mamba_keys = {"w_in", "w_out", "conv_w", "a_log", "dt_bias", "d_skip",
                  "norm"}
    kinds = layer_kinds(tcfg)
    assert len(tp["layers"]) == len(kinds) == cfg.n_layers
    for i, (kind, lp) in enumerate(zip(kinds, tp["layers"])):
        p, pos = divmod(i, len(cfg.pattern))
        ref = rp["period"][f"pos{pos}"]
        assert sorted(lp) == sorted(ref)
        if kind in "mM":
            assert set(lp["mamba"]) == mamba_keys
        want = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a)[p], ref))
        got = tree_leaves(lp)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    own = init_params(tcfg, device="cpu", dtype=torch.float32)
    for a, b in zip(tree_leaves(own), tree_leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match(arch):
    cfg, rp, tcfg, tp, r_prefill = _models(arch)
    toks = _tokens(cfg, 12)
    with torch.no_grad():
        tl, caches = prefill_step(tp, tcfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  init_caches(tcfg, 2, 16, device="cpu"))
    assert tl.dtype == torch.float32
    _rel_close(tl, r_prefill(toks), 1e-5)
    for kind, c in zip(layer_kinds(tcfg), caches):
        assert isinstance(c, SSMState) == (kind in "mM")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_the_longer_prefill(arch):
    """The port's prefill over 12 tokens, then one decode step, gives the
    reference's prefill logits over all 13: the mamba layers continue from
    the state after the prompt."""
    cfg, rp, tcfg, tp, r_prefill = _models(arch)
    toks = _tokens(cfg, 13)
    with torch.no_grad():
        _, caches = prefill_step(tp, tcfg,
                                 {"tokens": torch.from_numpy(toks[:, :12])},
                                 init_caches(tcfg, 2, 16, device="cpu"))
        td, _ = decode_step(tp, tcfg,
                            {"tokens": torch.from_numpy(toks[:, 12:])},
                            caches)
    _rel_close(td, r_prefill(toks), DECODE_REL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference_prefill_argmax(arch):
    """Greedy tokens of ``ServeEngine.generate`` (prompts of 11 and 8
    tokens, the second left-padded with token 0 as the engine pads) equal
    the argmax of the reference's prefill over the padded prompts and the
    tokens generated so far (11, 12 and 13 tokens)."""
    cfg, rp, tcfg, tp, r_prefill = _models(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (11, 8)]
    new = 3
    got = ServeEngine(tcfg, tp, max_len=16, batch_slots=2,
                      device="cpu").generate(prompts, max_new_tokens=new,
                                             sync_every=0)
    seq = np.zeros((2, 11), np.int64)
    for i, p in enumerate(prompts):
        seq[i, 11 - len(p):] = p
    want = []
    for _ in range(new):
        nxt = r_prefill(seq).argmax(-1)
        want.append(nxt)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(got.tokens, np.stack(want, axis=1))
    assert got.prefill_len == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_block_apply_runs_every_mode(arch):
    """Each mamba kind of the arch in "train", "prefill" and "decode":
    train and prefill give the same output, decode continues the prefill's
    state, and a mamba cache is an ``SSMState``."""
    _, _, tcfg, tp, _ = _models(arch)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 10, tcfg.d_model)).astype(np.float32))
    for kind, lp in zip(layer_kinds(tcfg), tp["layers"]):
        if kind not in "mM":
            continue
        cache = block_cache_init(tcfg, kind, 2, 16, device="cpu")
        assert isinstance(cache, SSMState)
        with torch.no_grad():
            ht, ct, _ = block_apply(lp, tcfg, kind, x, cache, "train")
            hp, cp, _ = block_apply(lp, tcfg, kind, x[:, :9], cache,
                                    "prefill")
            hd, cd, _ = block_apply(lp, tcfg, kind, x[:, 9:], cp, "decode")
        assert ct is cache
        _rel_close(hp, ht[:, :9].numpy(), 1e-6)
        _rel_close(hd, ht[:, 9:].numpy(), 1e-5)
        assert isinstance(cd, SSMState)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _batch(cfg):
    return RDataset(cfg.vocab, 64, 2, seed=1).batch(0)


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


@functools.lru_cache(maxsize=None)
def _reference_grads(arch):
    cfg, rp, *_ = _models(arch)
    vg = jax.jit(jax.value_and_grad(functools.partial(
        rmodels.loss_fn, cfg=cfg, use_kernel=False), has_aux=True))
    (loss, metrics), grads = vg(rp, batch={
        k: jnp.asarray(v) for k, v in _batch(cfg).items()})
    return loss, metrics, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch):
    cfg, rp, tcfg, tp, _ = _models(arch)
    _, rmet, rg = _reference_grads(arch)
    grads, met = _grads(tcfg, tp, _torch_batch(_batch(cfg)))
    assert sorted(met) == sorted(rmet)
    for k in rmet:
        _rel_close(met[k].reshape(()), rmet[k], 1e-5)
    want = tree_leaves(params_from_reference(jax.tree.map(np.asarray, rg),
                                             tcfg, device="cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        _rel_close(g, w.numpy(), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_block_is_bitwise_none(arch):
    _, _, tcfg, tp, _ = _models(arch)
    b = _torch_batch(_batch(tcfg))
    g0, m0 = _grads(tcfg, tp, b)
    g1, m1 = _grads(dataclasses.replace(tcfg, remat="block"), tp, b)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, c) for a, c in zip(g0, g1))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches(arch):
    """The port's ``make_train_step`` from the reference's initial train
    state against the reference's ``adamw_update`` on the reference's
    gradient of the same batch (what its ``make_train_step`` does)."""
    cfg, rp, tcfg, _, _ = _models(arch)
    opt = dict(lr=1e-4, warmup_steps=1, total_steps=10)
    rs = r_init_train_state(cfg, rp)
    _, _, rg = _reference_grads(arch)
    want, _, rmet = jax.jit(functools.partial(r_adamw_update,
                                              RAdamWConfig(**opt)))(
        rs.params, rg, rs.opt)
    ts = train_state_from_reference(jax.tree.map(np.asarray, rs), tcfg,
                                    device="cpu")
    ts, met = make_train_step(tcfg, AdamWConfig(**opt))(
        ts, _torch_batch(_batch(cfg)))
    for k in rmet:
        _rel_close(met[k].reshape(()), rmet[k], 1e-5)
    want = params_from_reference(jax.tree.map(np.asarray, want), tcfg,
                                 device="cpu")
    for a, w in zip(tree_leaves(ts.params), tree_leaves(want)):
        _rel_close(a, w.numpy(), 1e-4)


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs(arch, capsys):
    assert serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--max-new", "4"]) == 0
    assert "generated" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs(arch, tmp_path, capsys):
    assert train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "32",
                           "--ckpt-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.rstrip().endswith("done")
