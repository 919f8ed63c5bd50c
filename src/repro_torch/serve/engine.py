"""Batched LM decode serving engine: prefill + decode with slot batching
(counterpart of ``repro/serve/engine.py``).

``ServeEngine`` runs static-slot batching: up to ``n_slots`` sequences
form a wave, are left-padded with token 0 to the wave's longest prompt,
prefilled together, and decode in lockstep (one ``decode_fn`` call per
token); the next wave starts when every slot of this one is done.  Greedy
(``argmax``, first index on ties) or temperature sampling from a
``torch.Generator`` seeded with ``ServeConfig.seed`` — the same
distribution as the reference's ``jax.random.categorical``, not the same
draws.

It feeds the model ``{"tokens": ...}`` only, as the reference's engine
does, so it serves the dense, MoE, hybrid and RWKV families; their caches
(KV, Mamba and RWKV states) are the model's own.  Whisper and the VLM run
through ``Model.prefill_fn`` and ``Model.decode_fn`` directly.

Compute is bf16, as in the reference; the parameters are cast once, at
construction, onto the engine's device (the card unless the CPU is asked),
leaves whose spec fixes their dtype (f32 routers and SSM decay logs) as
they are.
``serve_step_fn(model)`` is the dry-run's serve step: one ``decode_fn``
call over a full cache (the ``decode_*`` / ``long_*`` cells count and
run exactly this).

Each wave's timings land in ``ServeEngine.waves``, read at the points where
the host already waits for the device (the sampled tokens), so recording
them adds no synchronisation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.model import Model, cast_params

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    n_slots: int = 4
    temperature: float = 0.0  # 0 → greedy
    eos_id: int = -1  # -1 → run to max_new_tokens
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 32
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class WaveStats:
    batch: int  # requests in the wave
    prompt_len: int  # the wave's padded prompt length S
    prompt_tokens: int  # Σ real prompt lengths
    prefill_s: float  # wave start → first tokens on the host (TTFT)
    decode_steps: int  # decode_fn calls
    decode_tokens: int  # tokens emitted after the first, Σ over requests
    decode_s: float  # first tokens → last tokens on the host


class ServeEngine:
    def __init__(self, model: Model, params: nn.Module, cfg: ServeConfig,
                 *, device=None):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.inference_mode():  # trainable params cast as data
            self.params = cast_params(model.cfg, params, COMPUTE_DTYPE,
                                      self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.waves: list[WaveStats] = []

    def _prefill(self, tokens: torch.Tensor):
        return self.model.prefill_fn(self.params, {"tokens": tokens},
                                     self.cfg.max_len, dtype=COMPUTE_DTYPE)

    def _decode(self, cache, tokens: torch.Tensor, pos: int):
        return self.model.decode_fn(self.params, cache, tokens, pos,
                                    dtype=COMPUTE_DTYPE)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits[..., : self.model.cfg.vocab_size]
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve requests in waves of ``n_slots`` (static-slot batching).

        All prompts within a wave are right-aligned to the wave's max prompt
        length (left-padding) so decode positions align.  Runs under
        ``torch.inference_mode()``: no autograd graph, whatever the
        parameters' ``requires_grad``.
        """
        queue = list(requests)
        with torch.inference_mode():
            while queue:
                wave = queue[: self.cfg.n_slots]
                queue = queue[len(wave):]
                self._run_wave(wave)
        return requests

    def _run_wave(self, wave: list[Request]) -> None:
        t0 = time.perf_counter()
        b = len(wave)
        s = max(len(r.prompt) for r in wave)
        tokens = np.zeros((b, s), np.int64)
        for i, r in enumerate(wave):
            tokens[i, s - len(r.prompt):] = r.prompt  # left-pad
        logits, cache = self._prefill(torch.from_numpy(tokens).to(self.device))
        next_tok = self._sample(logits)
        max_new = max(r.max_new_tokens for r in wave)
        pos = s
        active = np.ones(b, bool)
        t_first = None
        steps = emitted = 0
        for _ in range(max_new):
            host_tok = next_tok.cpu().numpy()
            if t_first is None:
                t_first = time.perf_counter()
            for i, r in enumerate(wave):
                if active[i]:
                    tok = int(host_tok[i])
                    r.output.append(tok)
                    emitted += 1
                    if (
                        tok == self.cfg.eos_id
                        or len(r.output) >= r.max_new_tokens
                    ):
                        r.done = True
                        active[i] = False
            if not active.any() or pos >= self.cfg.max_len - 1:
                break
            logits, cache = self._decode(cache, next_tok, pos)
            next_tok = self._sample(logits)
            steps += 1
            pos += 1
        for r in wave:
            r.done = True
        t_end = time.perf_counter()
        t_first = t_end if t_first is None else t_first
        self.waves.append(WaveStats(
            batch=b, prompt_len=s,
            prompt_tokens=sum(len(r.prompt) for r in wave),
            prefill_s=t_first - t0, decode_steps=steps,
            decode_tokens=emitted - min(emitted, b), decode_s=t_end - t_first))


def serve_step_fn(model: Model) -> Callable:
    """The dry-run's serve_step: one decode step over a full cache
    (the ``decode_*`` / ``long_*`` cells count exactly this)."""

    def serve_step(params, cache, tokens, pos):
        return model.decode_fn(params, cache, tokens, pos)

    return serve_step
