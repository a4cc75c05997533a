"""Batched executor: one dispatch per same-signature micro-batch.

Feeds the batch's table dicts to the cached executable from
``PlanCache.get_or_compile_batched`` (stacked on a leading axis, the plan
body under ``torch.func.vmap``, per-request slices: one CUDA-graph replay on
the card). Singleton batches take the plain cached executable: they share
it with non-batched traffic, so a signature's first lonely request doesn't
compile a B=1 vmap variant nobody else will use.

The reference's multi-device routes (a mesh's sharded batches, partitioned
oversized queries) are not ported yet (ROADMAP.md, queue 1 item 12): a
``mesh`` raises ``NotImplementedError``.

All request timestamps (``dispatch_t``, ``finish_t``) come from the
executor's own single clock read bracketing the dispatch, which ends when
the results' stream has finished (``jax.block_until_ready`` in the
reference), so ``finish_t - dispatch_t`` equals the measured dispatch
duration exactly.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.core.plan_cache import NOT_PORTED, PlanCache
from repro_torch.serving.batcher import MicroBatch


def block_until_ready(results) -> None:
    """Wait for the stream the results were computed on (the current stream
    of their device); nothing to wait for on the CPU."""
    for table in results:
        if table.device.type == "cuda":
            torch.cuda.current_stream(table.device).synchronize()
            return


class BatchedExecutor:
    def __init__(self, cache: Optional[PlanCache] = None,
                 backend: Optional[str] = None,
                 mesh=None,
                 clock: Callable[[], float] = time.monotonic, device=None):
        if mesh is not None:
            raise NotImplementedError(f"BatchedExecutor(mesh=...): {NOT_PORTED}")
        self.cache = cache or PlanCache(device=device)
        self.backend = backend  # node-level lowering override (torch/kernel)
        self.mesh = mesh
        self.clock = clock  # same timebase as request timestamps
        self.dispatches = 0
        self.batched_dispatches = 0
        self.sharded_dispatches = 0      # multi-device counters: stay 0
        self.partitioned_dispatches = 0  # until queue 1 item 12

    def dispatch(self, batch: MicroBatch) -> float:
        """Execute the micro-batch; fill each request's result. Returns the
        duration of the (blocking) dispatch on the executor's clock."""
        reqs = batch.requests
        rep = reqs[0]  # same signature => same compiled program; any member
        t0 = self.clock()
        if len(reqs) == 1:
            run = self.cache.get_or_compile(rep.plan, rep.catalog,
                                            backend=self.backend,
                                            cache_key=batch.key)
            results = [run(rep.tables)]
            block_until_ready(results)
        else:
            run = self.cache.get_or_compile_batched(
                rep.plan, rep.catalog, len(reqs), backend=self.backend,
                cache_key=batch.key)
            results = run(tuple(r.tables for r in reqs))
            block_until_ready(results)
            # counters record *completed* dispatches only: a raising
            # dispatch is the server's failure path, not a batched one
            self.batched_dispatches += 1
        dt = self.clock() - t0
        self.dispatches += 1
        for req, res in zip(reqs, results):
            req.result = res
            req.done = True
            req.dispatch_t = t0
            req.finish_t = t0 + dt
            req.batch_size = len(reqs)
        return dt
