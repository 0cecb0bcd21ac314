"""Training driver: config-driven, checkpointed, restartable (port of the
JAX package's ``launch/train.py``: the same flags and lines, plus
``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

  # the reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1_5_0_5b \
      --reduced --steps 8 --batch 2 --seq 16 --device cpu

Without ``--reduced`` it trains the published config with its activations
in its parameters' dtype (float32), and says so on its first line: the
reference's layer scan rejects the published bfloat16-over-float32 mix
(ROADMAP §3). ``--remat`` keeps the reference's quirk: ``store_true`` with a
default of True, so remat is always on from the command line and
``models.transformer.set_remat_policy`` picks what it keeps.
Restart-resume: re-running with the same --ckpt-dir continues from the
latest checkpoint. An injected failure (``--fail-at-step``) lets pending
checkpoint writes land before it raises, as a crash after the last save.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.serve import resolve_config
from repro_torch.models.model import Model, build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, synthetic_batch
from repro_torch.training.train_step import TrainConfig, TrainState, init_state, train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--remat", action="store_true", default=True)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="fault-injection: crash at this step (FT testing)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    return ap


class Trained(NamedTuple):
    losses: list  # the logged losses, as the reference returns them
    state: TrainState
    model: Model
    start_step: int  # 0, or the checkpoint's step it resumed from
    step_ms: list  # each step's time: CUDA events on the card, the host clock on the CPU


class _StepTimer:
    """Each step's time without a read of the card in the loop: CUDA events
    around each step, read once at the end; the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> list:
        pairs = list(zip(self.marks[::2], self.marks[1::2]))
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def run(argv=None) -> Trained:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg, note = resolve_config(args.arch, args.reduced)
    model = build_model(cfg)
    tcfg = TrainConfig(
        adamw=opt.AdamWConfig(
            learning_rate=args.lr, warmup_steps=min(20, args.steps // 10),
            total_steps=args.steps,
        ),
        remat=args.remat,
        grad_compression=args.grad_compression,
    )
    dcfg = DataConfig(seed=args.seed, batch=args.batch, seq=args.seq)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"[train] arch={cfg.name}{note} {cfg.n_params() / 1e6:.1f} M params, "
          f"batch {args.batch}x{args.seq} on {where}")

    state = init_state(model, args.seed, tcfg, dev)
    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        start_step, state, meta = ckpt.restore(state)
        print(f"[train] resumed from step {start_step}")

    losses, metrics = [], None
    timer = _StepTimer(dev)
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            if step == args.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = synthetic_batch(cfg, dcfg, step, dev)
            timer.mark()
            state, metrics = train_step(state, batch, model, tcfg)
            timer.mark()
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.time() - t0
                print(
                    f"[train] step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {metrics['lr']:.2e} ({dt:.1f}s)"
                )
            if ckpt and step > 0 and step % args.ckpt_every == 0:
                ckpt.save(step + 1, state, {"loss": float(metrics["loss"])})
        if ckpt and metrics is not None:
            ckpt.save(args.steps, state, {"loss": float(metrics["loss"])})
    finally:
        if ckpt:
            ckpt.wait()
    if losses:
        print(f"[train] done: first logged loss {losses[0]:.4f} → last {losses[-1]:.4f}")
    return Trained(losses, state, model, start_step, timer.ms())


if __name__ == "__main__":
    run()
