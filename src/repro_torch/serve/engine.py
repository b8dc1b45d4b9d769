"""Batched serving engine: request queue → padded prefill → decode loop.

The port of ``repro.serve.engine``: requests fill a fixed number of batch
slots, prompts are left-padded to one length, prefill populates the KV
caches, and a greedy (argmax) or sampled decode loop runs until every slot
has emitted EOS or ``max_new_tokens`` tokens exist.

On a CUDA device every prefill attention runs on the hand-written
``flash_attention`` kernel and every expert FFN on ``moe_gemm``; there is
no switch to the plain versions on the card. On the CPU the plain versions
run.

The decode loop stays on the device: per-step tokens and the EOS mask are
device tensors, and the only device→host copies are the early-exit probe
every ``sync_every`` steps and one final copy of the token matrix. Lengths
(excluding EOS) and the masking of slots after a request's EOS are derived
on the host from that one matrix.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.device_common import resolve_device
from ..models import decode_step, init_caches, prefill_step

__all__ = ["ServeEngine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, <=max_new) generated ids; slots past
                                  # a request's EOS are masked to eos_id
    lengths: np.ndarray           # (B,) tokens generated per request,
                                  # EXCLUDING the EOS token itself
    prefill_len: int


def _to_host(t: torch.Tensor) -> np.ndarray:
    """The one way the engine copies a device tensor to the host."""
    return t.cpu().numpy()


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 512,
                 batch_slots: int = 4, eos_id: int = -1, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.eos_id = eos_id
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")

    @torch.no_grad()
    def generate(self, prompts: List[np.ndarray], *, max_new_tokens: int = 16,
                 greedy: bool = True, seed: int = 0,
                 sync_every: int = 8) -> GenerationResult:
        """prompts: list of 1-D int arrays (ragged), at most
        ``batch_slots``. Greedy decoding takes the argmax; sampling draws
        from the softmax with a ``torch.Generator`` seeded with ``seed``.
        ``sync_every`` is the early-exit probe's cadence in steps (0 = never
        probe, always run ``max_new_tokens`` steps)."""
        if not prompts:
            return GenerationResult(tokens=np.zeros((0, 0), np.int32),
                                    lengths=np.zeros(0, np.int64),
                                    prefill_len=0)
        if len(prompts) > self.batch_slots:
            raise ValueError(f"{len(prompts)} prompts for "
                             f"{self.batch_slots} batch slots")
        b = self.batch_slots
        plen = max(len(p) for p in prompts)
        if plen + max_new_tokens - 1 > self.max_len:
            raise ValueError(f"{plen} prompt + {max_new_tokens} new tokens "
                             f"do not fit max_len={self.max_len}")
        toks = np.zeros((b, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p          # left-pad (causal-safe)

        caches = init_caches(self.cfg, b, self.max_len, device=self.device)
        logits, caches = prefill_step(
            self.params, self.cfg,
            {"tokens": torch.from_numpy(toks).to(self.device)}, caches)

        gen = None
        if not greedy:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        steps = []                               # device-resident (b,) tokens
        seen_eos = torch.zeros(b, dtype=torch.bool, device=self.device)
        for t in range(max_new_tokens):
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                        generator=gen)[:, 0]
            steps.append(nxt)
            seen_eos |= nxt == self.eos_id
            if t + 1 == max_new_tokens:
                break
            if sync_every and (t + 1) % sync_every == 0 \
                    and bool(_to_host(seen_eos.all())):
                break                            # every slot has finished
            logits, caches = decode_step(
                self.params, self.cfg, {"tokens": nxt[:, None]}, caches)

        out = _to_host(torch.stack(steps, dim=1)).astype(np.int32)  # ONE sync
        nsteps = out.shape[1]
        is_eos = out == self.eos_id
        # first EOS position per row, or nsteps when the row never finished
        first = np.where(is_eos.any(axis=1),
                         is_eos.argmax(axis=1), nsteps).astype(np.int64)
        # a finished row kept decoding until the batch stopped: everything
        # at/after its EOS is not part of the answer — mask it to eos_id
        out = np.where(np.arange(nsteps)[None, :] > first[:, None],
                       self.eos_id, out).astype(np.int32)
        return GenerationResult(tokens=out[:len(prompts)],
                                lengths=first[:len(prompts)],
                                prefill_len=plen)
