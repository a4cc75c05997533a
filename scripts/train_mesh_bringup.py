#!/usr/bin/env python3
"""Bring-up run of LM training on a (data, model) mesh on one CUDA card.

    python3 scripts/train_mesh_bringup.py

1. Prints Python's and torch's versions, then ``chip_smoke.py``'s device
   line (the card's name and power limit).
2. On 4 gloo ranks sharing cuda:0: ``reduce_scatter_tensor`` and
   ``all_gather_into_tensor`` of float32 and bfloat16 CUDA tensors, each
   beside the sum it should give, or the error gloo raises.
3. ``chip_smoke.py``'s build phase and its ``[lm-train-mesh]`` phase alone.

Exits non-zero without CUDA or if a check fails.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402
from repro_torch.testing import spawn_ranks  # noqa: E402


def collectives_rank(rank: int, ways: int) -> None:
    import torch.distributed as dist
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.arange(2 * ways, device="cuda") + rank).to(dt)
        out = torch.empty(2, dtype=dt, device="cuda")
        try:
            dist.reduce_scatter_tensor(out, x)
            want = torch.arange(2 * rank, 2 * rank + 2, device="cuda") * ways + sum(range(ways))
            got = f"{out.tolist()} (want {want.tolist()})"
        except RuntimeError as e:
            got = f"refused: {str(e).splitlines()[0][:200]}"
        g = torch.empty(ways, dtype=dt, device="cuda")
        dist.all_gather_into_tensor(g, torch.tensor([rank], dtype=dt, device="cuda"))
        if rank == 0:
            print(f"gloo cuda {dt}: reduce_scatter_tensor {got}; all_gather_into_tensor "
                  f"{g.tolist()}", flush=True)


def main() -> int:
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = C.phase_device()
    spawn_ranks(collectives_rank, C.MESH_RANKS, device="cuda:0")
    C.timed(C.phase_build)()
    C.timed(C.phase_lm_train_mesh)(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
