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
* The bf16 route's arithmetic: QKᵀ in fp32 from bf16 q and k, an online
  softmax over the kernel's key blocks, P rounded to bf16 before PV and l
  summed from the unrounded p, modelled here in float32 torch and held
  against the Pallas kernel in interpret mode within the bf16 tolerance
  ``chip_smoke.py`` holds the card to (atol 2e-2 + rtol 1e-2), at head
  dims 128, 160 and 256.
* ``route`` and the wrapper's argument checks per route: what the prefill
  path hands the kernel on a card passes them (run on CPU tensors, at each
  architecture's published head dim in bf16, and in float32 at each smoke
  config's own head dim and at 160), and what the kernels do not take
  raises. The float32 route pads the head dim to a multiple of 64 with
  zero columns; the plain version on zero-padded inputs gives the same
  output. The CUDA kernels themselves run only on a card
  (``chip_smoke.py``).
* ``cuda_lib.library_path`` names a new library when a header the source
  includes changes.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import \
    multihead_attention as r_multihead_attention
from repro.kernels.flash_attention.ref import attention_ref as r_attention_ref
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import multihead_attention
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attention_ref,
                                                     fold_gqa, mha_ref)
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


def _checked_calls(monkeypatch):
    """Route every attention call through ``check_launch_args`` first and
    record (q shape, k shape, dtype, keyword arguments)."""
    inner = tkernel.flash_attention
    calls = []

    def checked(q, k, v, **kw):
        tkernel.check_launch_args(q, k, v, torch.empty_like(q))
        calls.append((tuple(q.shape), tuple(k.shape), q.dtype, kw))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(tkernel, "flash_attention", checked)
    return calls


def _prefill(cfg, dtype):
    params = init_params(cfg, device="cpu", dtype=dtype)
    r = np.random.default_rng(0)
    if cfg.input_kind == "embeds":
        batch = {"embeds": torch.from_numpy(
            r.standard_normal((2, 13, cfg.d_model)).astype(np.float32))
            .to(dtype)}
    else:
        batch = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab,
                                                       (2, 13)))}
    logits, _ = prefill_step(params, cfg, batch,
                             init_caches(cfg, 2, 16, device="cpu"))
    assert torch.isfinite(logits).all()


def test_prefill_hands_the_kernel_arguments_it_accepts(monkeypatch):
    """Every attention launch of a bf16 prefill would pass the kernel's
    checks, at each architecture's published head dim: the op runs on CPU
    tensors with each call checked first. Narrow widths and 2 layers;
    qwen2-moe-a2.7b at 128, gemma2-2b at 256 with its window and softcap,
    qwen3-8b at 128 with GQA 4/1, pixtral-12b at 160 from embeddings."""
    calls = _checked_calls(monkeypatch)
    want = {"qwen2-moe-a2.7b": 128, "gemma2-2b": 256, "qwen3-8b": 128,
            "pixtral-12b": 160}
    for arch, hd in want.items():
        assert get_config(arch).hd == hd
        cfg = dataclasses.replace(smoke_config(arch), head_dim=hd,
                                  n_layers=2, dtype="bfloat16")
        before = len(calls)
        _prefill(cfg, torch.bfloat16)
        mine = calls[before:]
        assert len(mine) == 2                   # one launch per layer
        assert {c[0][3] for c in mine} == {hd}
        assert {c[2] for c in mine} == {torch.bfloat16}
        assert {tkernel.route(c[2], c[0][3]) for c in mine} == {"tc"}
        if arch == "gemma2-2b":
            assert {c[3]["window"] for c in mine} == {0, 8}   # 'l' and 'a'
            assert {c[3]["softcap"] for c in mine} == {50.0}
        if arch == "qwen3-8b":
            assert {c[1][2] for c in mine} == {1} and mine[0][0][2] == 4


def test_prefill_f32_hands_the_fp32_route_arguments_it_accepts(monkeypatch):
    """The float32 check's path (qwen2-moe-a2.7b's head dim 128, 2 layers)
    would pass the fp32 route's checks."""
    calls = _checked_calls(monkeypatch)
    cfg = dataclasses.replace(smoke_config("qwen2-moe-a2.7b"), head_dim=128,
                              n_layers=2)
    _prefill(cfg, torch.float32)
    assert len(calls) == 2
    assert {tkernel.route(c[2], c[0][3]) for c in calls} == {"fp32"}


SMOKE_ATTENTION_ARCHS = ("musicgen-large", "pixtral-12b", "gemma2-2b",
                         "mistral-large-123b", "qwen3-8b", "nemotron-4-15b",
                         "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b")


@pytest.mark.parametrize("arch", SMOKE_ATTENTION_ARCHS)
def test_smoke_config_prefill_hands_the_fp32_route_arguments_it_accepts(
        monkeypatch, arch):
    """``launch.serve --smoke`` runs each attention architecture's smoke
    config in float32 at its own head dim (16): every attention launch of
    its prefill passes the fp32 route's checks, and so does the same
    config at pixtral-12b's published head dim of 160."""
    calls = _checked_calls(monkeypatch)
    cfg = smoke_config(arch)
    assert cfg.dtype == "float32" and cfg.hd == 16
    for hd in (cfg.hd, 160):
        before = len(calls)
        _prefill(dataclasses.replace(cfg, head_dim=hd), torch.float32)
        mine = calls[before:]
        assert len(mine) == sum(k in "aAl" for k in cfg.pattern) \
            * cfg.n_periods
        assert {c[0][3] for c in mine} == {hd}
        assert {tkernel.route(c[2], c[0][3]) for c in mine} == {"fp32"}


@pytest.mark.parametrize("d", [8, 16, 40, 160, 200])
def test_fp32_route_zero_padding_changes_nothing(d):
    """The fp32 kernel runs at D rounded up to 64 with the columns past D
    read as zeros and never stored; the plain version on inputs padded so
    gives the unpadded output (float32, within 1e-6: the longer dot
    products add exact zeros, summed in another blocking)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 77, 4, 2, d, seed=d))
    dp = -(-d // 64) * 64
    pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))
    kw = dict(scale=d ** -0.5, causal=True, window=32, softcap=30.0)
    got = mha_ref(pad(q), pad(k), pad(v), **kw)
    assert torch.all(got[..., d:] == 0)
    torch.testing.assert_close(got[..., :d], mha_ref(q, k, v, **kw),
                               atol=1e-6, rtol=1e-5)


def _misaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose data starts one element past
    a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "gqa", "contiguous",
                                  "out_shape", "bf16_d100", "bf16_d264",
                                  "f32_d100", "f32_d264", "misaligned",
                                  "bf16_misaligned",
                                  "bf16_contiguous"])
def test_check_launch_args_rejects(case):
    q = torch.zeros(1, 8, 4, 64)
    k = v = torch.zeros(1, 8, 2, 64)
    out = torch.empty_like(q)
    if case == "head_dim":
        q, k, v, out = (t[..., :12].contiguous() for t in (q, k, v, out))
    elif case == "dtype":
        q, out = q.half(), out.half()
    elif case == "gqa":
        k = v = torch.zeros(1, 8, 3, 64)
    elif case == "contiguous":
        q = torch.zeros(1, 4, 8, 64).transpose(1, 2)
    elif case == "out_shape":
        out = torch.empty(1, 8, 2, 64)
    elif case.startswith(("bf16_d", "f32_d")):
        d = int(case.split("_d")[1])
        dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
        q = torch.zeros(1, 8, 4, d, dtype=dtype)
        k = v = torch.zeros(1, 8, 2, d, dtype=dtype)
        out = torch.empty_like(q)
    elif case == "misaligned":
        k = _misaligned((1, 8, 2, 64), torch.float32)
    elif case == "bf16_misaligned":
        q, k, v = (t.bfloat16() for t in (q, k, v))
        out = _misaligned((1, 8, 4, 64), torch.bfloat16)
    else:
        q = torch.zeros(1, 4, 8, 160, dtype=torch.bfloat16).transpose(1, 2)
        k = v = torch.zeros(1, 8, 2, 160, dtype=torch.bfloat16)
        out = torch.empty(1, 8, 4, 160, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tkernel.check_launch_args(q, k, v, out)


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 96), (torch.bfloat16, 160), (torch.bfloat16, 8),
    (torch.bfloat16, 256), (torch.float32, 64), (torch.float32, 256),
    (torch.float32, 16), (torch.float32, 160), (torch.float32, 8)])
def test_check_launch_args_accepts(dtype, d):
    q = torch.zeros(2, 9, 4, d, dtype=dtype)
    k = v = torch.zeros(2, 9, 2, d, dtype=dtype)
    tkernel.check_launch_args(q, k, v, torch.empty_like(q))


def test_route_by_dtype_and_head_dim():
    """bf16 takes every multiple of 8 up to 256 on the tensor-core route,
    float32 the same head dims on the CUDA-core route; anything else
    raises."""
    for d in range(8, 257, 8):
        assert tkernel.route(torch.bfloat16, d) == "tc"
        assert tkernel.route(torch.float32, d) == "fp32"
    bad = [(torch.bfloat16, d) for d in (0, 4, 100, 260, 264, 512)]
    bad += [(torch.float32, d) for d in (0, 4, 12, 100, 264, 512)]
    bad += [(torch.float16, 128), (torch.float64, 64)]
    for dtype, d in bad:
        with pytest.raises(ValueError):
            tkernel.route(dtype, d)


def _tc_model(q, k, v, *, scale, causal, window, softcap):
    """The bf16 route's arithmetic on (B, S, H, D) bf16 tensors, in float32
    torch: per key block of the kernel's size (128 keys at head dim <= 128,
    else 64), logits from the bf16 inputs in fp32, scale, softcap,
    mask to -1e30, the online max m and rescale exp(m_old - m_new), p
    rounded to bf16 before PV, l summed from the unrounded p; divide by l
    (1 where it is 0) and round the output to bf16."""
    b, s, hq, d = q.shape
    qf, kf, vf = (t.float() for t in fold_gqa(q, k, v))
    bk = 128 if d <= 128 else 64
    rows = torch.arange(s)[:, None]
    m = torch.full((b * hq, s, 1), NEG_INF)
    l = torch.zeros(b * hq, s, 1)
    acc = torch.zeros(b * hq, s, d)
    for k0 in range(0, s, bk):
        kb, vb = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        x = torch.einsum("bqd,bkd->bqk", qf, kb) * scale
        if softcap > 0.0:
            x = softcap * torch.tanh(x / softcap)
        cols = torch.arange(k0, k0 + kb.shape[1])[None, :]
        mask = torch.ones(s, kb.shape[1], dtype=torch.bool)
        if causal:
            mask &= cols <= rows
        if window > 0:
            mask &= cols > rows - window
        x = torch.where(mask, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(x - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bqk,bkd->bqd", p.bfloat16().float(), vb)
        m = m_new
    out = (acc / torch.where(l == 0.0, 1.0, l)).bfloat16()
    return out.reshape(b, hq, s, d).permute(0, 2, 1, 3)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 50.0)])
@pytest.mark.parametrize("s", [77, 200])
@pytest.mark.parametrize("d", [128, 160, 256])
def test_bf16_route_rounding_stays_within_the_chip_tolerance(d, s, window,
                                                             softcap):
    """The tensor-core route rounds P to bf16 where the Pallas kernel keeps
    it in f32; modelled on the same bf16 inputs, the result stays within
    the bf16 tolerance the card is held to (atol 2e-2 + rtol 1e-2), GQA
    4/2 included. The largest error is printed (``pytest -rP`` shows it)."""
    r = np.random.default_rng(d + s + window)
    q, k, v = (r.standard_normal((1, s, h, d)).astype(np.float32)
               for h in (4, 2, 2))
    as_bf16 = lambda a: torch.from_numpy(a).bfloat16()
    kw = dict(scale=d ** -0.5, causal=True, window=window, softcap=softcap)
    want = np.asarray(r_multihead_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        kw["scale"], True, window, softcap, True, True), np.float32)
    got = _tc_model(as_bf16(q), as_bf16(k), as_bf16(v), **kw).float().numpy()
    err = np.abs(got - want)
    worst = float(err.max())
    where = f"D={d} S={s} window={window} softcap={softcap}"
    print(f"largest error {worst} at {where}")
    assert np.all(err <= 2e-2 + 1e-2 * np.abs(want)), (
        f"largest error {worst} at {where}")
    assert worst > 0.0, "the model should differ from the f32-P kernel"
    # and it is the port's own plain version up to that rounding
    plain = mha_ref(as_bf16(q), as_bf16(k), as_bf16(v), **kw).float().numpy()
    np.testing.assert_allclose(got, plain, atol=2e-2, rtol=1e-2)


def test_library_path_hashes_the_included_headers(tmp_path):
    """An edited header names a new library for every source that includes
    it (directly or through another header); an unrelated file does not."""
    csrc = tmp_path / "kern" / "csrc"
    csrc.mkdir(parents=True)
    src = csrc / "k.cu"
    src.write_text('#include <cuda.h>\n#include "../../shared.cuh"\n'
                   "extern \"C\" int f() { return 0; }\n")
    shared = tmp_path / "shared.cuh"
    inner = tmp_path / "inner.cuh"
    shared.write_text('#pragma once\n#include "inner.cuh"\n')
    inner.write_text("#pragma once\n// v1\n")
    (tmp_path / "unrelated.cuh").write_text("// v1\n")
    assert cuda_lib.local_headers(src) == [shared.resolve(), inner.resolve()]
    first = cuda_lib.library_path(src)
    assert cuda_lib.library_path(src) == first
    (tmp_path / "unrelated.cuh").write_text("// v2\n")
    assert cuda_lib.library_path(src) == first
    inner.write_text("#pragma once\n// v2\n")
    second = cuda_lib.library_path(src)
    assert second != first and second.stem.startswith("k-")
    shared.write_text('#pragma once\n#include "inner.cuh"\n// v2\n')
    assert cuda_lib.library_path(src) not in (first, second)


def test_every_kernel_source_hashes_its_headers():
    """The tensor-core sources include the shared PTX header, and their
    libraries' names cover it."""
    header = (Path(cuda_lib.__file__).parent / "hopper.cuh").resolve()
    from repro_torch.kernels.moe_gemm import kernel as mkernel
    for src in (tkernel.TC_SOURCE, mkernel.TC_SOURCE):
        assert header in cuda_lib.local_headers(src)
    assert cuda_lib.local_headers(tkernel.SOURCE) == []


def test_plain_version_in_the_model_layout():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 33, 4, 2, 16, seed=2))
    got = mha_ref(q, k, v, scale=0.25)
    kk, vv = (t.repeat_interleave(2, dim=2) for t in (k, v))
    for h in range(4):
        one = attention_ref(q[:, :, h], kk[:, :, h], vv[:, :, h], scale=0.25)
        torch.testing.assert_close(got[:, :, h], one, rtol=0, atol=0)
