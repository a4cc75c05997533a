"""Training loop with checkpoint/restart, preemption handling and
straggler watchdog hooks, the port of ``repro.train.loop`` on one device:
the card unless the caller names the CPU."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamW
from repro_torch.train.stragglers import PreemptionGuard


@dataclasses.dataclass
class TrainResult:
    step: int
    losses: list
    preempted: bool = False
    resumed_from: Optional[int] = None


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          microbatches: int = 1, lr: float = 3e-4, seed: int = 0,
          guard: Optional[PreemptionGuard] = None,
          hook: Optional[Callable[[int, Dict], None]] = None,
          device=None) -> TrainResult:
    """Trains ``cfg`` from ``lm.init_params(cfg, seed, device)`` with AdamW on
    ``TokenPipeline`` batches of ``batch`` x ``seq`` tokens, resuming from
    the latest checkpoint under ``ckpt_dir`` and saving (params, optimizer
    state, pipeline state) every ``ckpt_every`` steps and when ``guard``
    reports a preemption, after which it stops. ``hook(step, {"loss",
    "dt"})`` sees every step; ``dt`` is the host's seconds for the step,
    which waits for its loss."""
    dev = resolve_device(device)
    opt = AdamW(lr=lr)
    params = lm.init_params(cfg, seed, dev)
    opt_state = opt.init(params)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed)
    step_fn = lm.make_train_step(cfg, opt, microbatches=microbatches)
    start = 0
    resumed_from = None
    if ckpt_dir is not None:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            (params, opt_state, pipe_state), start = ckpt.restore(
                ckpt_dir, (params, opt_state, (0, 0)), cfg=cfg)
            pipe.restore(tuple(int(x) for x in pipe_state))
            resumed_from = start
    losses = []
    preempted = False
    for step in range(start, steps):
        t0 = time.perf_counter()
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_dev)
        loss = float(metrics["loss"])
        losses.append(loss)
        if hook:
            hook(step, {"loss": loss, "dt": time.perf_counter() - t0})
        should_ckpt = ckpt_dir is not None and (
            (step + 1) % ckpt_every == 0
            or (guard is not None and guard.preempted))
        if should_ckpt:
            ckpt.save(ckpt_dir, step + 1, (params, opt_state, pipe.state()), cfg=cfg)
        if guard is not None and guard.preempted:
            preempted = True
            break
    return TrainResult(step=step + 1 if steps > start else start,
                       losses=losses, preempted=preempted,
                       resumed_from=resumed_from)
