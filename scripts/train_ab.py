#!/usr/bin/env python3
"""granite-3-2b's bf16 train step in two checkouts, on one card.

    python3 scripts/train_ab.py --other DIR [--steps N]

``DIR`` is another checkout of this repo (for example the parent commit,
unpacked with ``git archive``). Each turn runs in a process of its own, in
the order other, this, this, other, with that checkout's code: the
``[lm-train]`` step of its ``chip_smoke.py`` (full width and depth, remat,
AdamW, one seeded ``TokenPipeline`` batch of B 4 x 2048 in 2
microbatches), N steps (default 6) timed on the host clock to the loss,
then one traced step: the device's busy ms (the sum of its kernels' times)
and the ms of flash_attention's backward kernels (names under ``fab::``)
in it. Prints each turn's line and a JSON summary beside the card's name
and power limit. Exits non-zero without CUDA or if a turn fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def turn(root: Path, steps: int) -> dict:
    """One checkout's step ms (median of all but the first), the traced
    step's busy ms and its backward kernels' ms."""
    sys.path.insert(0, str(root))
    import chip_smoke as C
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train.optim import AdamW
    C.phase_device()
    cfg = get_config(C.LM_ARCH)
    params = lm.init_params(cfg, seed=0, device="cuda")
    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    step = lm.make_train_step(cfg, opt, microbatches=C.LM_TRAIN_MICRO)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=C.LM_TRAIN_BATCH, seq=C.LM_TRAIN_SEQ, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.next_batch().items()}
    ms, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, state, m = step(params, state, batch)
        float(m["loss"])
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return {"step_ms": statistics.median(ms[1:]), "steps_ms": [round(x, 1) for x in ms],
            "losses": [round(x, 4) for x in losses], "busy_ms": sum(r[1] for r in rows),
            "backward_ms": sum(r[1] for r in rows if "fab::" in r[0])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        print("TURN " + json.dumps(turn(args.turn.resolve(), args.steps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_ab: CUDA is not available")
    other = args.other.resolve()
    results: dict = {"other": [], "this": []}
    for name, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        out = subprocess.run([sys.executable, __file__, "--turn", str(root),
                              "--steps", str(args.steps)],
                             capture_output=True, text=True, timeout=900)
        print(f"--- {name} ({root})\n{out.stdout}{out.stderr[-4000:]}", flush=True)
        if out.returncode != 0:
            raise SystemExit(f"train_ab: the {name} turn exited {out.returncode}")
        line = [x for x in out.stdout.splitlines() if x.startswith("TURN ")][-1]
        results[name].append(json.loads(line[5:]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[train-ab] {card.strip()}: " + json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
