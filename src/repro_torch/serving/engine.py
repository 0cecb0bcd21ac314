"""Batched generation engine: prefill once, then greedy (or temperature)
decode token by token with an optional EOS early exit (port of the JAX
package's ``serving/engine.py``).

The engine runs on ``device`` (the GPU unless the caller asks for the
CPU). Sampling draws from a ``torch.Generator`` on that device seeded from
``ServeConfig.seed``: Gumbel-max over logits / T, as
``jax.random.categorical`` samples, though not its bits. Without an EOS id
nothing in the loop reads the card, so the host queues steps ahead of it;
with one, ``all(done)`` is read once a step, as the reference does. The
engine stamps the stream before prefill and after every step (CUDA events
on the card), read back by `step_ms`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 → greedy
    eos_id: Optional[int] = None
    seed: int = 0


class Engine:
    def __init__(self, model: Model, params, serve_cfg: ServeConfig = ServeConfig(),
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = params.to(self.device)  # nn.Module.to: moved in place
        self.cfg = serve_cfg
        self._stamps = []

    def _stamp(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._stamps.append(ev)
        else:
            self._stamps.append(time.perf_counter())

    def step_ms(self) -> dict:
        """The last `generate`'s times: ``prefill_ms`` (prefill and the
        first token's sample) and ``decode_ms`` (one entry a decode step),
        from CUDA events on the card, the host clock on the CPU."""
        s = self._stamps
        if self.device.type == "cuda":
            s[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(s, s[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(s, s[1:])]
        return {"prefill_ms": ms[0], "decode_ms": ms[1:]}

    def _sample(self, logits, gen):
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits / self.cfg.temperature + gumbel, dim=-1)

    @torch.inference_mode()
    def generate(self, batch) -> np.ndarray:
        """batch: {"tokens": (B, S_prompt), ...family extras} (tensors or
        arrays). Returns the generated token matrix (B, max_new_tokens)."""
        mcfg = self.model.cfg
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        batch["tokens"] = batch["tokens"].long()
        bsz, prompt_len = batch["tokens"].shape
        extra = mcfg.frontend_seq if mcfg.family == "vlm" else 0
        s_max = prompt_len + extra + self.cfg.max_new_tokens + 1

        self._stamps = []
        self._stamp()
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        logits, state = self.model.prefill(self.params, batch, s_max)
        tok = self._sample(logits[:, 0], gen)
        self._stamp()

        out = [tok]
        done = torch.zeros((bsz,), dtype=torch.bool, device=self.device)
        for _ in range(self.cfg.max_new_tokens - 1):
            logits, state = self.model.decode_step(self.params, tok, state)
            tok = self._sample(logits, gen)
            if self.cfg.eos_id is not None:
                done = done | (tok == self.cfg.eos_id)
                tok = torch.where(done, self.cfg.eos_id, tok)
                if bool(torch.all(done)):
                    out.append(tok)
                    self._stamp()
                    break
            out.append(tok)
            self._stamp()
        return torch.stack(out, dim=1).cpu().numpy()
