"""Serving entry point: batched generation over the prefill/decode substrate
(port of the JAX package's ``launch/serve.py``: the same flags and lines,
plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --batch 4 --prompt-len 16 --new-tokens 32 --full-size

  # the reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --device cpu

Reduced (CPU smoke) configs are the default; ``--full-size`` takes the
published config with its activations in its parameters' dtype (float32):
every published config keeps the default bfloat16 activations over
float32 parameters, a mix the reference's own layer scan rejects
(ROADMAP §3), so the port runs only ``dtype == param_dtype``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine, ServeConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", dest="reduced", action="store_true",
                    default=True,
                    help="CPU smoke-test config (default)")
    ap.add_argument("--full-size", dest="reduced", action="store_false",
                    help="published full-size config, activations in float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    return ap


def resolve_config(arch: str, reduced: bool):
    """(config, note for the first line): the reduced config, or the
    published one with ``dtype`` set to its ``param_dtype``."""
    if reduced:
        return configs.get_reduced(arch), ""
    cfg = configs.get_config(arch)
    if cfg.dtype == cfg.param_dtype:
        return cfg, ""
    note = (f" dtype={cfg.param_dtype} (published {cfg.dtype}: the reference "
            "runs only dtype == param_dtype, ROADMAP §3)")
    return dataclasses.replace(cfg, dtype=cfg.param_dtype), note


class Served(NamedTuple):
    tokens: np.ndarray  # (batch, new tokens)
    engine: Engine
    batch: dict  # the prompt, on the engine's device
    seconds: float  # generate()'s wall time


def run(argv=None) -> Served:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg, note = resolve_config(args.arch, args.reduced)
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    engine = Engine(
        model, params,
        ServeConfig(max_new_tokens=args.new_tokens, temperature=args.temperature),
        device=dev,
    )

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                generator=gen, device=dev)
    }
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(
            (args.batch, cfg.frontend_seq, cfg.d_model), generator=gen, device=dev)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev)

    t0 = time.perf_counter()
    out = engine.generate(batch)
    dt = time.perf_counter() - t0
    tps = out.size / dt
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"[serve] arch={cfg.name}{note} generated {out.shape} in {dt:.2f}s "
          f"({tps:.0f} tok/s on {where})")
    print(f"[serve] first rows: {out[:2, :12].tolist()}")
    return Served(out, engine, batch, dt)


if __name__ == "__main__":
    run()
