"""Batched serving engine: length-bucketed waves of prefill + lockstep decode.

The reference's `repro.serving.engine` in PyTorch. Requests are grouped
into waves of identical (prompt length, temperature) via the shared
`serving.scheduler.WaveScheduler`, so a wave shares one host `pos`, a
rectangular cache layout and one sampling temperature; a request is
admitted only if its prompt plus its new tokens fit the cache.

Each wave runs `models.model.prefill` (every RWKV6 or Mamba2 layer's scan
through the chunk_scan kernel on the card) and then `decode_step` per new
token (every attention layer, self and cross, through the decode_attn
kernel), for every family (dense, moe, ssm, hybrid, vlm, audio): the cache
is whatever `prefill` returns. A MoE model's prefill runs at the
reference's serving capacity (cf 2.0) and its decode steps drop nothing;
the engine passes no capacity of its own. The audio and VLM families'
prefill also takes the frontend stub's output; the engine passes zeros for
it (`frames` (B, 1500, D), `patches` (B, 1024, D)), as the reference's
engine does; the other families take the tokens alone. Greedy
sampling is argmax; a temperature draws from a `torch.Generator` on the
engine's device seeded from `seed`, so sampled tokens differ from the
reference's `jax.random.categorical` by construction (greedy ones do not).
Times are host-clock differences (`obs.timers.now`) around work that ends
in `torch.cuda.synchronize` on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.obs import timers
from repro_torch.serving.scheduler import WaveScheduler


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 => greedy


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray  # generated tokens
    prefill_s: float
    decode_s: float  # shared by every result of the same wave
    tokens_per_s: float
    wave_id: int = -1  # which wave served this request


class Engine(WaveScheduler):
    """Length/temperature-bucketed batch serving over a fixed-size cache.

    `params` must lie on `device` (default CUDA; the CPU only when asked)."""

    def __init__(self, cfg, params, *, cache_len: int = 256, max_batch: int = 8,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__(max_batch=max_batch)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.cache_len = cache_len
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._waves_served = 0

    def _validate(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.cache_len:
            raise ValueError(f"request {req.uid} exceeds the cache: {len(req.prompt)} + "
                             f"{req.max_new_tokens} > {self.cache_len}")

    def bucket_key(self, req: Request):
        # A wave samples at ONE temperature, so temperature is part of the key.
        return (len(req.prompt), float(req.temperature))

    def _sample(self, logits: torch.Tensor, temperature: float) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0].to(torch.int32)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _extra_inputs(self, b: int) -> dict:
        """The frontend stub's output for a wave of `b`: zero frame or patch
        embeddings in the activations' type (the weights')."""
        cfg = self.cfg
        dtype = self.params["embed"].dtype
        if cfg.arch_type == "vlm":
            return {"patches": torch.zeros((b, cfg.num_frontend_tokens, cfg.d_model),
                                           dtype=dtype, device=self.device)}
        if cfg.arch_type == "audio":
            return {"frames": torch.zeros((b, cfg.encoder_tokens, cfg.d_model), dtype=dtype,
                                          device=self.device)}
        return {}

    @torch.inference_mode()
    def _run_wave(self, wave: list[Request]) -> list[Result]:
        b = len(wave)
        plen = len(wave[0].prompt)
        prompts = torch.as_tensor(np.stack([r.prompt for r in wave]).astype(np.int32),
                                  device=self.device)
        batch = {"tokens": prompts, **self._extra_inputs(b)}

        t0 = timers.now()
        cache, logits = M.prefill(self.params, self.cfg, batch, self.cache_len)
        self._sync()
        prefill_s = timers.now() - t0

        max_new = max(r.max_new_tokens for r in wave)
        temp = wave[0].temperature  # uniform within a wave (bucket_key)
        out = torch.zeros((b, max_new), dtype=torch.int32, device=self.device)
        tok = self._sample(logits, temp)
        t1 = timers.now()
        for i in range(max_new):
            out[:, i] = tok
            if i == max_new - 1:
                break
            cache, logits = M.decode_step(self.params, self.cfg, cache, tok, plen + i)
            tok = self._sample(logits, temp)
        out = out.cpu().numpy()  # waits for the last step
        decode_s = timers.now() - t1

        wave_id = self._waves_served
        self._waves_served += 1
        return [Result(uid=r.uid, tokens=out[j, :r.max_new_tokens], prefill_s=prefill_s,
                       decode_s=decode_s, tokens_per_s=b * max_new / max(decode_s, 1e-9),
                       wave_id=wave_id)
                for j, r in enumerate(wave)]
