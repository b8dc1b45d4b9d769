"""The port's training runtime against the reference, on the CPU.

* ``data.SyntheticLMDataset`` / ``make_batch_iterator``: every batch bitwise
  the reference's (tokens, labels and ``embeds``), per shard, and the
  iterator's skip-ahead starts on the batch the dataset gives for that step.
* ``train.optimizer``: ``cosine_schedule`` and ``clip_by_global_norm``
  against the reference's functions within rtol 1e-6, ``adamw_update``
  (three steps on a mixed tree, one clipped) within rtol 1e-5 on the
  parameters and both moments (float32; ``pow``, ``cos`` and ``sqrt`` may
  differ in the last place between XLA and torch, and the moments carry
  it over three steps); the update is in place; ``compress_int8`` /
  ``decompress_int8`` bitwise (q, scale and the residual), alone and over a
  64-step error-feedback loop.
* ``runtime.StragglerStats`` on the reference's own timing sequences
  (``tests/test_checkpoint_runtime.py``): the same flags and summaries.
* ``runtime.TrainLoopRunner``: a run killed by its batch function resumes
  from its last checkpoint, in place, bitwise equal to an uninterrupted run
  (losses and every state leaf); transient step failures retry; the
  checkpoint keeps the port's own keys (``params/layers/<i>/...``).
* ``models.convert.train_state_from_reference``: the reference's
  ``TrainState`` arrays land in the port's layout, dtypes as documented.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
from repro.configs import smoke_config as r_smoke_config
from repro.data import SyntheticLMDataset as RDataset
from repro.runtime import StragglerStats as RStragglerStats
from repro.train import adamw_init as r_adamw_init
from repro.train import adamw_update as r_adamw_update
from repro.train import clip_by_global_norm as r_clip
from repro.train import compress_int8 as r_compress
from repro.train import cosine_schedule as r_cosine
from repro.train import decompress_int8 as r_decompress
from repro.train import init_train_state as r_init_train_state
from repro_torch.checkpoint import latest_step
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLMDataset, make_batch_iterator
from repro_torch.models import (init_params, params_from_reference,
                                train_state_from_reference)
from repro_torch.runtime import (RetryPolicy, StepTimer, StragglerStats,
                                 TrainLoopRunner)
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               adamw_update, clip_by_global_norm,
                               compress_int8, cosine_schedule,
                               decompress_int8, init_train_state,
                               make_train_step)
from repro_torch.train.optimizer import tree_leaves, tree_map


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tokens", "embeds"])
@pytest.mark.parametrize("shard,nshards", [(0, 1), (1, 2), (3, 4)])
def test_batches_are_the_references_bit_for_bit(kind, shard, nshards):
    args = dict(vocab=97, seq_len=24, global_batch=8, seed=5,
                input_kind=kind, d_model=12)
    mine, ref = SyntheticLMDataset(**args), RDataset(**args)
    for step in (0, 1, 7, 1000):
        got = mine.batch(step, shard, nshards)
        want = ref.batch(step, shard, nshards)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (k, step)
    if kind == "embeds":
        assert got["embeds"].shape == (8 // nshards, 24, 12)


def test_iterator_skips_ahead():
    ds = SyntheticLMDataset(64, 16, 4, seed=2)
    it = make_batch_iterator(ds, start_step=5, shard=1, nshards=2)
    try:
        for step in (5, 6, 7):
            got = next(it)
            want = ds.batch(step, 1, 2)
            assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    finally:
        it.close()


def test_shards_must_divide_the_batch():
    with pytest.raises(ValueError, match="do not divide"):
        SyntheticLMDataset(64, 16, 6, seed=2).batch(0, 0, 4)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def _np_tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"w": (r.standard_normal((6, 5)) * scale).astype(np.float32),
            "nested": {"b": (r.standard_normal(7) * scale)
                       .astype(np.float32),
                       "list": [(r.standard_normal((3, 2)) * scale)
                                .astype(np.float32)]}}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 50, 109, 110, 200])
def test_cosine_schedule_matches(step):
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=110)
    got = cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = r_cosine(cfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    _close(got, want, atol=1e-12)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches(scale):
    g = _np_tree(1, scale)
    got, gn = clip_by_global_norm(_to_torch(g), 1.0)
    want, rgn = r_clip(_to_jax(g), 1.0)
    _close(gn, rgn)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        _close(a, b)


def test_adamw_update_matches_three_steps():
    """Three steps on the same gradients (one large enough to clip), the
    port's update in place, the reference's functional."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    p_np = _np_tree(0)
    tp, rp = _to_torch(p_np), _to_jax(p_np)
    ts, rs = adamw_init(tp), r_adamw_init(rp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for i, scale in enumerate((0.1, 30.0, 1.0)):
        g = _np_tree(10 + i, scale)
        tp, ts, tm = adamw_update(cfg, tp, _to_torch(g), ts)
        rp, rs, rmet = r_adamw_update(cfg, rp, _to_jax(g), rs)
        _close(tm["opt/grad_norm"], rmet["opt/grad_norm"])
        _close(tm["opt/lr"], rmet["opt/lr"])
        assert int(ts.step) == int(rs.step) == i + 1
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(rp)):
            _close(a, b, rtol=1e-5, atol=1e-7)
        for a, b in zip(tree_leaves(ts.mu) + tree_leaves(ts.nu),
                        jax.tree.leaves(rs.mu) + jax.tree.leaves(rs.nu)):
            _close(a, b, rtol=1e-5, atol=1e-12)


def test_adamw_updates_in_place():
    tp = _to_torch(_np_tree(0))
    before = [t.data_ptr() for t in tree_leaves(tp)]
    state = adamw_init(tp)
    new_p, new_s, _ = adamw_update(AdamWConfig(), tp,
                                   _to_torch(_np_tree(3)), state)
    assert [t.data_ptr() for t in tree_leaves(new_p)] == before
    assert new_s.mu is state.mu and int(new_s.step) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_is_bitwise_the_references(seed):
    r = np.random.default_rng(seed)
    g = (r.standard_normal((64, 33)) * 10.0 ** (seed - 1)).astype(np.float32)
    res = (r.standard_normal((64, 33)) * 1e-3).astype(np.float32)
    q, s, nr = compress_int8(torch.from_numpy(g), torch.from_numpy(res))
    rq, rs, rnr = r_compress(jnp.asarray(g), jnp.asarray(res))
    assert q.dtype == torch.int8
    assert q.numpy().tobytes() == np.asarray(rq).tobytes()
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    assert nr.numpy().tobytes() == np.asarray(rnr).tobytes()
    assert decompress_int8(q, s).numpy().tobytes() == \
        np.asarray(r_decompress(rq, rs)).tobytes()


def test_error_feedback_loop_is_bitwise_the_references():
    """64 steps of compress / decompress with the residual carried: every
    step's dequantized gradient and residual equal bit for bit, and their
    mean converges to the gradient (the reference's own check)."""
    g = (np.random.default_rng(1).standard_normal(512) * 1e-3) \
        .astype(np.float32)
    tres, rres = torch.zeros(512), jnp.zeros(512)
    acc = torch.zeros(512)
    for _ in range(64):
        q, s, tres = compress_int8(torch.from_numpy(g), tres)
        rq, rs, rres = r_compress(jnp.asarray(g), rres)
        rec = decompress_int8(q, s)
        assert rec.numpy().tobytes() == \
            np.asarray(r_decompress(rq, rs)).tobytes()
        assert tres.numpy().tobytes() == np.asarray(rres).tobytes()
        acc += rec
    np.testing.assert_allclose((acc / 64).numpy(), g, atol=float(s) / 8)


# --------------------------------------------------------------------------
# straggler stats (the reference's sequences)
# --------------------------------------------------------------------------

def _both(window=50, z=3.0):
    return StragglerStats(window, z), RStragglerStats(window, z)


def _record(pair, dt):
    a, b = pair[0].record(dt), pair[1].record(dt)
    assert a == b
    return a


def test_straggler_flags_a_slow_step_as_the_reference_does():
    pair = _both()
    for _ in range(30):
        _record(pair, 0.1 + np.random.default_rng(0).random() * 1e-3)
    assert _record(pair, 1.0) is True
    assert pair[0].flagged == pair[1].flagged == 1
    assert pair[0].summary() == pair[1].summary()


def test_straggler_window_and_warmup_as_the_reference():
    pair = _both(window=20)
    for _ in range(9):
        assert _record(pair, 0.1) is False
    assert _record(pair, 50.0) is False
    assert _record(pair, 0.5) is False
    for _ in range(20):
        _record(pair, 0.1)
    assert _record(pair, 1.0) is True
    assert pair[0].summary() == pair[1].summary()


def test_straggler_summary_fields_as_the_reference():
    pair = _both()
    assert pair[0].summary() == pair[1].summary() == \
        {"step_time_mean": 0.0, "stragglers": 0}
    for dt in (0.1, 0.2, 0.3):
        _record(pair, dt)
    assert pair[0].summary() == pair[1].summary()


def test_step_timer_measures_the_block():
    with StepTimer() as t:
        sum(range(1000))
    assert t.dt >= 0.0


# --------------------------------------------------------------------------
# the train loop: checkpoint, kill, resume
# --------------------------------------------------------------------------

def _smoke_state(seed=0, compress=False):
    cfg = smoke_config("qwen2-moe-a2.7b")
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu", dtype=torch.float32)
    return cfg, init_train_state(cfg, params, compress=compress)


def _batches(cfg, seq=16, batch=4):
    ds = SyntheticLMDataset(cfg.vocab, seq, batch, seed=3)

    def get(step):
        out = {k: torch.from_numpy(v) for k, v in ds.batch(step).items()}
        out["tokens"] = out["tokens"].long()
        return out
    return get


class _Killed(Exception):
    pass


def test_runner_resumes_bitwise_after_a_kill(tmp_path):
    """Six steps checkpointed every 3: a run whose batch function raises at
    step 4 resumes in a new runner from step 3's checkpoint (copied into a
    fresh state's tensors) and ends bitwise where the uninterrupted run
    ends, every loss of the resumed steps equal too."""
    cfg, _ = _smoke_state()
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=6,
                                               warmup_steps=1),
                              compress_grads=True)
    get = _batches(cfg)

    def run(ckpt, batches, steps, state):
        logged = {}
        runner = TrainLoopRunner(step_fn, state, str(ckpt), ckpt_every=3)
        runner.run(batches, steps, log_every=1,
                   log_fn=lambda s, m: logged.__setitem__(s, m["loss/ce"]))
        return runner, logged

    uninterrupted, whole = run(tmp_path / "a", get, 6,
                               _smoke_state(compress=True)[1])

    def killing(step):
        if step == 4:
            raise _Killed("killed at step 4")
        return get(step)

    with pytest.raises(_Killed):
        run(tmp_path / "b", killing, 6, _smoke_state(compress=True)[1])
    assert latest_step(str(tmp_path / "b")) == 3
    fresh = _smoke_state(seed=9, compress=True)[1]     # other values
    runner, resumed = run(tmp_path / "b", get, 3, fresh)
    assert runner.start_step == 3 and sorted(resumed) == [3, 4, 5]
    assert runner.state.params["embed"] is fresh.params["embed"]  # in place
    for s in (3, 4, 5):
        assert resumed[s] == whole[s]
    assert int(runner.state.opt.step) == 6
    for a, b in zip(tree_leaves(runner.state),
                    tree_leaves(uninterrupted.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert latest_step(str(tmp_path / "b")) == 6


def test_checkpoint_keys_are_the_ports_layout(tmp_path):
    import json
    cfg, state = _smoke_state()
    TrainLoopRunner(make_train_step(cfg, AdamWConfig()), state,
                    str(tmp_path), ckpt_every=1).run(_batches(cfg), 1)
    meta = json.loads((tmp_path / "step_00000001" / "meta.json")
                      .read_text())
    keys = meta["keys"]
    assert "params/embed" in keys and "opt/step" in keys
    assert "params/layers/1/moe/experts_up" in keys
    assert "opt/mu/layers/0/attn/wq" in keys
    assert not any(k.startswith("residual") for k in keys)
    assert not any("period" in k for k in keys)


def test_runner_retries_a_transient_step(tmp_path):
    sleeps, calls = [], {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("a launch failed")
        return state + 1, {"loss": torch.tensor(0.0)}

    r = TrainLoopRunner(step_fn, torch.tensor(0), str(tmp_path),
                        ckpt_every=100,
                        retry=RetryPolicy(max_retries=2, backoff_s=0.25),
                        retry_sleep=sleeps.append)
    out = r.run(lambda s: None, 3)
    assert int(out) == 3 and calls["n"] == 4 and sleeps == [0.25]


# --------------------------------------------------------------------------
# the reference's train state in the port's layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_train_state_from_reference(compress):
    cfg = r_smoke_config("gemma2-2b")
    rp = rmodels.init_params(cfg, jax.random.PRNGKey(0))
    rs = r_init_train_state(cfg, rp, compress=compress)
    rs = rs._replace(opt=rs.opt._replace(
        mu=jax.tree.map(lambda p: p * 0.5, rs.opt.mu),
        step=jnp.asarray(7, jnp.int32)))
    np_state = jax.tree.map(np.asarray, rs)
    ts = train_state_from_reference(np_state, cfg, device="cpu")
    assert isinstance(ts, TrainState)
    assert ts.opt.step.dtype == torch.int32 and int(ts.opt.step) == 7
    want = params_from_reference(np_state.params, cfg, device="cpu")
    for a, b in zip(tree_leaves(ts.params), tree_leaves(want)):
        assert torch.equal(a, b)
    assert len(ts.params["layers"]) == cfg.n_layers
    for tree in (ts.opt.mu, ts.opt.nu):
        assert {t.dtype for t in tree_leaves(tree)} == {torch.float32}
    assert (ts.residual is None) == (not compress)
    bf = train_state_from_reference(np_state, cfg, device="cpu",
                                    dtype=torch.bfloat16)
    assert {t.dtype for t in tree_leaves(bf.params)} == {torch.bfloat16}
    assert {t.dtype for t in tree_leaves(bf.opt.mu)} == {torch.float32}
