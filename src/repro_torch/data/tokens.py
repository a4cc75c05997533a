"""Deterministic synthetic token pipeline for LM training, the port of
``repro.data.tokens``: numpy on the host, batch for batch the reference's.

A host-side generator produces Zipf-distributed token streams with a simple
Markov structure (so a real model can measurably learn), sharded by
(host_id, num_hosts) so every data-parallel worker reads a disjoint slice.
Fully seekable: ``state`` is just (seed, step), which is what
checkpoint/resume stores. The batches are numpy arrays; the train loop
moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    step: int = 0

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + self.host_id)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng_for(self.step)
        self.step += 1
        b = self.batch // self.num_hosts
        v = self.vocab - 1
        # noisy affine bigram: token_{t+1} = (a*token_t + c) mod v with 15%
        # random resets, a learnable next-token function
        tokens = np.empty((b, self.seq), np.int64)
        tokens[:, 0] = rng.integers(0, v, b)
        noise = rng.random((b, self.seq)) < 0.15
        rand = rng.integers(0, v, (b, self.seq))
        for t in range(1, self.seq):
            nxt = (tokens[:, t - 1] * 31 + 7) % v
            tokens[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        tokens = tokens.astype(np.int32)
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}

    def state(self) -> Tuple[int, int]:
        return (self.seed, self.step)

    def restore(self, state: Tuple[int, int]) -> None:
        self.seed, self.step = state
