"""The port's attention op against the reference's, on the CPU.

* ``multihead_attention``: the reference with ``use_kernel=True`` runs the
  Pallas kernel in interpret mode, as ``tests/test_kernels_attention.py``
  runs it; the port runs its plain version on CPU tensors. Covered: causal,
  sliding window, softcap, S = 77 (the reference pads it to 128; the port's
  kernel masks keys past S instead) and GQA (4/2, 8/1). Within atol 2e-5,
  rtol 1e-4 in float32 (the reference's own kernel tolerance), 3e-2 in
  bfloat16 (its bf16 kernel tolerance).
* ``attention_ref``: the two plain versions agree within 1e-6 on (BH, S, D),
  causal or not.
* The wrapper's argument checks: what the prefill path hands the kernel on
  a card passes them (run on CPU tensors), and what the kernel does not
  take raises. The CUDA kernel itself runs only on a card
  (``chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import \
    multihead_attention as r_multihead_attention
from repro.kernels.flash_attention.ref import attention_ref as r_attention_ref
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import multihead_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, mha_ref
from repro_torch.models import init_caches, init_params, prefill_step


def _qkv(b, s, hq, hkv, d, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((b, s, h, d)).astype(np.float32)
                 for h in (hq, hkv, hkv))


@pytest.mark.parametrize("s,hq,hkv,d,window,softcap", [
    (128, 4, 4, 32, 0, 0.0),       # causal
    (77, 4, 2, 32, 0, 0.0),        # pad path + GQA 4/2
    (77, 8, 1, 16, 0, 0.0),        # pad path + GQA 8/1
    (256, 2, 2, 64, 64, 0.0),      # sliding window
    (128, 4, 2, 32, 0, 50.0),      # softcap
    (200, 8, 1, 32, 48, 30.0),     # everything at once, ragged S
])
def test_multihead_attention_matches_pallas(s, hq, hkv, d, window, softcap):
    q, k, v = _qkv(2, s, hq, hkv, d)
    scale = d ** -0.5
    want = r_multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, True, window,
                                 softcap, True, True)
    got = multihead_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale, True, window,
                              softcap)
    assert got.shape == (2, s, hq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_multihead_attention_bf16_matches_pallas():
    q, k, v = _qkv(1, 128, 4, 2, 64, seed=4)
    as_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    want = r_multihead_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        0.125, True, 0, 0.0, True, True)
    got = multihead_attention(as_bf16(q), as_bf16(k), as_bf16(v), 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_non_causal_ragged_s_masks_keys_past_s():
    """Without the causal mask, the reference's kernel path attends to the
    zero keys it pads S with; the port masks keys past S and matches the
    reference's unpadded plain path instead."""
    q, k, v = _qkv(1, 77, 2, 2, 32, seed=5)
    args = (32 ** -0.5, False, 0, 0.0)
    plain = r_multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), *args, False, True)
    padded = r_multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), *args, True, True)
    got = multihead_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), atol=2e-5,
                               rtol=1e-4)
    assert np.abs(np.asarray(padded) - np.asarray(plain)).max() > 0.05


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0), (True, 0, 20.0)])
def test_plain_versions_agree(causal, window, softcap):
    r = np.random.default_rng(1)
    q, k, v = (r.standard_normal((3, 50, 16)).astype(np.float32)
               for _ in range(3))
    want = r_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale=0.25, causal=causal, window=window,
                           softcap=softcap)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), scale=0.25, causal=causal,
                        window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


def test_prefill_hands_the_kernel_arguments_it_accepts(monkeypatch):
    """Every attention launch of a prefill would pass the kernel's checks:
    the op runs on CPU tensors with each call checked first (head dim 64,
    so the smoke config's shapes are ones the kernel takes)."""
    inner = tkernel.flash_attention
    calls = []

    def checked(q, k, v, **kw):
        tkernel.check_launch_args(q, k, v, torch.empty_like(q))
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(tkernel, "flash_attention", checked)
    layers = 0
    for arch in ("qwen2-moe-a2.7b", "gemma2-2b", "qwen3-8b"):
        cfg = dataclasses.replace(smoke_config(arch), head_dim=64)
        layers += cfg.n_layers
        params = init_params(cfg, device="cpu", dtype=torch.float32)
        toks = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab, (2, 13)))
        prefill_step(params, cfg, {"tokens": toks},
                     init_caches(cfg, 2, 16, device="cpu"))
    assert len(calls) == layers                 # one launch per layer
    assert {c[2]["window"] for c in calls} == {0, 8}       # gemma2's 'l'


@pytest.mark.parametrize("case", ["head_dim", "dtype", "gqa", "contiguous",
                                  "out_shape"])
def test_check_launch_args_rejects(case):
    q = torch.zeros(1, 8, 4, 64)
    k = v = torch.zeros(1, 8, 2, 64)
    out = torch.empty_like(q)
    if case == "head_dim":
        q, k, v, out = (t[..., :16].contiguous() for t in (q, k, v, out))
    elif case == "dtype":
        q, out = q.half(), out.half()
    elif case == "gqa":
        k = v = torch.zeros(1, 8, 3, 64)
    elif case == "contiguous":
        q = torch.zeros(1, 4, 8, 64).transpose(1, 2)
    else:
        out = torch.empty(1, 8, 2, 64)
    with pytest.raises(ValueError):
        tkernel.check_launch_args(q, k, v, out)


def test_plain_version_in_the_model_layout():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 33, 4, 2, 16, seed=2))
    got = mha_ref(q, k, v, scale=0.25)
    kk, vv = (t.repeat_interleave(2, dim=2) for t in (k, v))
    for h in range(4):
        one = attention_ref(q[:, :, h], kk[:, :, h], vv[:, :, h], scale=0.25)
        torch.testing.assert_close(got[:, :, h], one, rtol=0, atol=0)
