#!/usr/bin/env python3
"""Bring-up run of LM training on one CUDA card.

    python3 scripts/train_bringup.py [--steps N] [--no-layers]

1. Prints Python's and torch's versions, then ``chip_smoke.py``'s device
   line (the card's name and power limit) and its build phase.
2. ``chip_smoke.py``'s training phases alone: ``[parity] flash_attention
   backward``, ``[lm-train]`` and ``[time] flash_attention backward``.
3. ``[layers]``: granite-3-2b's train step at full width and depth (bf16,
   remat, B 4 x 2048 in 2 microbatches, AdamW) with the stacked weights
   unbound once a forward (``lm._layers``) and, as a yardstick, selected
   one layer at a time (``w[i]`` for each leaf and layer: each select's
   backward writes a zero tensor of the whole stack), in turns unbind,
   select, select, unbind; N steps each (default 3), the median of all but
   the first, and the peak memory of each turn.

Exits non-zero without CUDA or if a check fails.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402


def select_layers(blocks: dict) -> list:
    """One dict of per-layer views, each leaf indexed once a layer."""
    n = next(iter(blocks.values())).shape[0]
    return [{k: w[i] for k, w in blocks.items()} for i in range(n)]


def layers_before_after(steps: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train.optim import AdamW
    cfg = get_config(C.LM_ARCH)
    params = lm.init_params(cfg, seed=0, device="cuda")
    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    step = lm.make_train_step(cfg, opt, microbatches=C.LM_TRAIN_MICRO)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=C.LM_TRAIN_BATCH, seq=C.LM_TRAIN_SEQ, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.next_batch().items()}
    unbind = lm._layers
    results: dict = {"unbind": [], "select": []}
    try:
        for name in ("unbind", "select", "select", "unbind"):
            lm._layers = unbind if name == "unbind" else select_layers
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(steps):
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                loss = float(m["loss"])
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 1e9
            results[name].append(statistics.median(ms[1:]))
            print(f"[layers] {name}: step ms {[round(x, 1) for x in ms]}, median of all "
                  f"but the first {statistics.median(ms[1:]):.1f}; peak {peak:.2f} GB; "
                  f"last loss {loss:.4f}", flush=True)
    finally:
        lm._layers = unbind
    print(f"[layers] {C.LM_ARCH} train step (B{C.LM_TRAIN_BATCH} x S{C.LM_TRAIN_SEQ}, "
          f"{C.LM_TRAIN_MICRO} microbatches): unbind once {results['unbind']} ms, select per "
          f"layer {results['select']} ms; power limit {C._smi('power.limit')}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--no-layers", action="store_true")
    args = ap.parse_args()
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = C.phase_device()
    C.timed(C.phase_build)()
    errs = C.timed(C.phase_attention_bwd_parity)()
    launches = C.timed(C.phase_lm_train)(card)
    C.timed(C.phase_attention_bwd_times)(launches, errs, card)
    if not args.no_layers:
        C.timed(layers_before_after)(args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
