#!/usr/bin/env python3
"""Bring-up run of the LM on a (data, model) mesh on one CUDA card.

    python3 scripts/lm_mesh_bringup.py

1. Prints Python's and torch's versions, then ``chip_smoke.py``'s device
   line (the card's name and power limit).
2. One bfloat16 all-reduce of CUDA tensors over 4 gloo ranks sharing
   cuda:0 (``1 + rank / 256`` and ``3``): whether gloo sums bf16 on this
   torch, beside the same sum in float32.
3. ``chip_smoke.py``'s build phase (the five kernels) and its
   ``[lm-mesh]`` phase alone: each LM config on one rank, then on 4 gloo
   ranks sharing the card, every rank held to the one-rank run.

Exits non-zero without CUDA or if a check fails.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402
from repro_torch.testing import spawn_ranks  # noqa: E402


def bf16_rank(rank: int, ways: int) -> None:
    import torch.distributed as dist
    x = torch.tensor([1.0 + rank / 256, 3.0], dtype=torch.bfloat16, device="cuda")
    dist.all_reduce(x)
    y = torch.tensor([1.0 + rank / 256, 3.0], dtype=torch.float32, device="cuda")
    dist.all_reduce(y)
    if rank == 0:
        print("gloo bf16 cuda all_reduce:", x.tolist(), x.dtype, "f32:", y.tolist(), flush=True)


def main() -> int:
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    C.phase_device()
    spawn_ranks(bf16_rank, C.MESH_RANKS, device="cuda:0")
    C.timed(C.phase_build)()
    C.timed(C.phase_lm_mesh)()
    return 0


if __name__ == "__main__":
    sys.exit(main())
