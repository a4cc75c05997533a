"""End-to-end LM training on the PyTorch port: train a reduced granite-3
family model for a few hundred steps with checkpoint/restart (data pipeline
-> AdamW -> checkpoints -> resume).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]

The port of ``examples/train_lm.py``: the same config (granite-3-2b's smoke
config at 4 layers, d_model 128, d_ff 512, vocab 512), flags, schedule
(half the steps with a checkpoint every 25, a simulated restart, a resume to
``--steps``) and lines. Its losses differ from the reference example's: the
port draws its initial weights from ``torch.Generator`` streams of its own
(``lm.init_params``), not from JAX's PRNG. From one shared checkpoint the
two packages take the same first steps (tests/test_torch_examples.py).

It runs on the CUDA card unless ``--device`` names another device, and
checkpoints under ``--ckpt-dir``, which it empties first: by default
``repro_torch_train_lm`` in the temporary directory (the reference's is
``/tmp/repro_train_lm``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
from typing import Callable, Optional

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.common import resolve_device
from repro_torch.train.loop import train

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
LR = 1e-3
CKPT_EVERY = 25
PRINT_EVERY = 20


def lm_config():
    """The example's model: granite-3-2b's smoke config, widened."""
    return dataclasses.replace(get_smoke_config("granite-3-2b"),
                               n_layers=4, d_model=128, d_ff=512, vocab=512)


def run(*, device=None, steps: int = 200, batch: int = 8, seq: int = 64,
        ckpt_dir: str = DEFAULT_CKPT_DIR,
        on_restart: Optional[Callable[[str], None]] = None) -> dict:
    """The example's two phases on ``device`` (the card unless named).
    ``on_restart(ckpt_dir)`` runs at the simulated restart, when the
    directory holds what phase 1 saved. Returns what it prints (``lines``),
    both phases' ``TrainResult``s and every step's host milliseconds
    (``step_ms``; a step waits for its loss)."""
    dev = resolve_device(device)
    cfg = lm_config()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    lines, step_ms = [], []

    def say(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    def hook(step, m):
        step_ms.append(m["dt"] * 1e3)
        if step % PRINT_EVERY == 0:
            say(f"step {step:4d}  loss {m['loss']:.4f}  "
                f"{m['dt'] * 1e3:6.1f} ms/step")

    half = steps // 2
    say(f"phase 1: {half} steps with checkpointing ...")
    first = train(cfg, steps=half, batch=batch, seq=seq, lr=LR, ckpt_dir=ckpt_dir,
                  ckpt_every=CKPT_EVERY, hook=hook, device=dev)
    say("simulated restart — resuming from the latest checkpoint ...")
    if on_restart is not None:
        on_restart(ckpt_dir)
    res = train(cfg, steps=steps, batch=batch, seq=seq, lr=LR, ckpt_dir=ckpt_dir,
                ckpt_every=CKPT_EVERY, hook=hook, device=dev)
    say(f"resumed from step {res.resumed_from}; "
        f"final loss {res.losses[-1]:.4f} "
        f"(from {res.losses[0]:.4f} post-resume)")
    return {"lines": lines, "phase1": first, "resumed": res, "step_ms": step_ms,
            "config": cfg}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default=None,
                    help="defaults to the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    run(device=args.device, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir)


if __name__ == "__main__":
    main()
