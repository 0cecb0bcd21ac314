"""Model facade: build once from a ModelConfig, get init/apply/serve fns
(port of the JAX package's ``models/model.py``).

The port keeps the reference's semantics, which are well defined only
where the activations' dtype is the parameters' (ROADMAP §3: at a mixed
dtype the reference's layer scan rejects its own carry), so a config with
``dtype != param_dtype`` raises here.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.dtype != self.cfg.param_dtype:
            raise ValueError(
                f"{self.cfg.name}: dtype={self.cfg.dtype!r} with param_dtype="
                f"{self.cfg.param_dtype!r}; the port runs only dtype == "
                "param_dtype (the reference's scan rejects a mixed dtype, "
                "ROADMAP §3)")

    def init(self, seed: int | torch.Generator = 0, device="cuda") -> T.LM:
        """Parameters drawn from ``seed`` (an int, or a generator whose
        device they land on) on ``device``, which defaults to the GPU."""
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return T.init_params(gen, self.cfg)

    def forward(self, params, batch):
        return T.forward(params, batch, self.cfg)

    def prefill(self, params, batch, s_max: int):
        return D.prefill(params, batch, self.cfg, s_max)

    def decode_step(self, params, token, state):
        return D.decode_step(params, token, state, self.cfg)

    def init_decode_state(self, batch: int, s_max: int, device="cuda"):
        return D.init_decode_state(self.cfg, batch, s_max, resolve_device(device))

    def param_shapes(self) -> dict:
        """{name: (shape, dtype)} of every parameter, built on the meta
        device: nothing is allocated."""
        params = T.LM(self.cfg, device=torch.device("meta"))
        return {n: (tuple(p.shape), p.dtype) for n, p in params.named_parameters()}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
