"""End-to-end LM training driver: trains a reduced qwen1.5 config for a
few hundred steps with AdamW, cosine schedule, remat, checkpointing and
restart; port of ``examples/train_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20 --device cpu

Arguments after the defaults go to `repro_torch.launch.train` (a later
flag wins). Checkpoints go to a new temporary directory unless
``--ckpt-dir`` names one, where a rerun resumes.

(The full-size configs train through the identical code path on the
production mesh; `repro_torch.launch.dryrun` traces that step, sharded,
for every cell.)
"""

from __future__ import annotations

import sys
import tempfile


def main(argv=None):
    from repro_torch.launch.train import run

    argv = list(sys.argv[1:] if argv is None else argv)
    args = [
        "--arch", "qwen1_5_0_5b", "--reduced",
        "--steps", "200", "--batch", "4", "--seq", "64",
        "--lr", "1e-3", "--ckpt-dir", tempfile.mkdtemp(prefix="repro_torch_train_"),
        "--ckpt-every", "50", "--log-every", "20",
    ] + argv
    losses = run(args).losses
    assert losses[-1] < losses[0], "loss did not decrease"
    print(f"loss {losses[0]:.3f} → {losses[-1]:.3f} over the run: OK")
    return losses


if __name__ == "__main__":
    main()
