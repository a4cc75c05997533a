"""Batched executor: one dispatch per same-signature micro-batch.

Feeds the batch's table dicts to the cached executable from
``PlanCache.get_or_compile_batched`` (stacked on a leading axis, the plan
body under ``torch.func.vmap``, per-request slices: one CUDA-graph replay on
the card). Singleton batches take the plain cached executable: they share
it with non-batched traffic, so a signature's first lonely request doesn't
compile a B=1 vmap variant nobody else will use.

With a ``mesh``, eligible batches (more than one rank and a batch size the
rank count divides: ``core.mesh.can_shard``) take the *sharded* executable
instead (``PlanCache.get_or_compile_sharded``) when the cost oracle
predicts it pays (``costed_lowering.choose_batch_realization``): the
stacked batch axis is split over the mesh's data axis, one slice per rank.
Ineligible batches fall back to the single-device vmapped program. An
explicit node-level ``backend`` override ('torch'/'kernel') takes
precedence over the mesh: the sharded realization lowers per node to
torch, so honoring the override means not sharding.

Requests the server flagged *partitioned* (oversized single queries whose
working set busts the per-device memory budget) take
``PlanCache.get_or_compile_partitioned`` instead: one intra-query-sharded
dispatch per request (operators partitioned over the mesh, no batch axis),
executed sequentially within the group. On a mesh every rank dispatches
the same batches by the same route (``QueryServer`` has rank 0 decide
both), since each route is a sequence of collectives.

All request timestamps (``dispatch_t``, ``finish_t``) come from the
executor's own single clock read bracketing the dispatch, which ends when
the results' stream has finished (``jax.block_until_ready`` in the
reference), so ``finish_t - dispatch_t`` equals the measured dispatch
duration exactly.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import costed_lowering
from repro_torch.core import mesh as mesh_util
from repro_torch.core.plan_cache import LRUCache, PlanCache
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
        self.cache = cache or PlanCache(device=device)
        self.backend = backend  # node-level lowering override (torch/kernel)
        self.mesh = mesh        # multi-rank batch sharding, when eligible
        self.clock = clock  # same timebase as request timestamps
        self.dispatches = 0
        self.batched_dispatches = 0
        self.sharded_dispatches = 0
        self.partitioned_dispatches = 0
        # batched-vs-sharded is a costed decision (the shared oracle against
        # the cache's profile); memoized off the dispatch path per
        # (signature, batch size, profile epoch)
        self._realization_memo = LRUCache(256)

    def _use_sharded(self, batch: MicroBatch) -> bool:
        reqs = batch.requests
        if (len(reqs) <= 1 or self.backend is not None
                or not mesh_util.can_shard(self.mesh, len(reqs))):
            return False
        mk = (batch.key, len(reqs), self.cache.profile_epoch)
        dec = self._realization_memo.get(mk)
        if dec is None:
            dec = costed_lowering.choose_batch_realization(
                reqs[0].plan, reqs[0].catalog, len(reqs), self.mesh,
                profile=self.cache.profile)
            self._realization_memo.put(mk, dec)
        return dec == "sharded"

    def route(self, batch: MicroBatch) -> Tuple[bool, bool]:
        """(partitioned, sharded) for the batch. Oversized single queries
        (flagged at admission: working set busts the per-device budget)
        take the partitioned executable. An explicit node-level backend
        override disables sharding: the sharded realization lowers per node
        to torch, and silently serving the same signature with different
        kernel realizations depending on batch size would discard the
        caller's choice exactly on the hot (grouped) traffic. Eligible
        batches still go through the cost oracle: sharding only when the
        profile predicts it pays."""
        partitioned = batch.requests[0].partitioned and self.mesh is not None
        return partitioned, (not partitioned) and self._use_sharded(batch)

    def dispatch(self, batch: MicroBatch,
                 route: Optional[Tuple[bool, bool]] = None) -> float:
        """Execute the micro-batch by ``route`` (``route(batch)`` if not
        given); fill each request's result. Returns the duration of the
        (blocking) dispatch on the executor's clock."""
        reqs = batch.requests
        rep = reqs[0]  # same signature => same compiled program; any member
        partitioned, sharded = route if route is not None else self.route(batch)
        batch.sharded, batch.partitioned = sharded, partitioned
        t0 = self.clock()
        if partitioned:
            # the caller's node-level kernel override constrains the
            # partitioned lowering too: partitioning is a distribution
            # choice, not a kernel one, so the two compose
            run = self.cache.get_or_compile_partitioned(
                rep.plan, rep.catalog, self.mesh, backend=self.backend,
                cache_key=batch.key)
            results = [run(r.tables) for r in reqs]
            block_until_ready(results)
            # per completed *batch*, like every other dispatch counter
            self.partitioned_dispatches += 1
        elif len(reqs) == 1:
            run = self.cache.get_or_compile(rep.plan, rep.catalog,
                                            backend=self.backend,
                                            cache_key=batch.key)
            results = [run(rep.tables)]
            block_until_ready(results)
        else:
            if sharded:
                run = self.cache.get_or_compile_sharded(
                    rep.plan, rep.catalog, len(reqs), self.mesh,
                    cache_key=batch.key)
            else:
                run = self.cache.get_or_compile_batched(
                    rep.plan, rep.catalog, len(reqs), backend=self.backend,
                    cache_key=batch.key)
            results = run(tuple(r.tables for r in reqs))
            block_until_ready(results)
            # counters record *completed* dispatches only: a raising
            # dispatch is the server's failure path, not a sharded/batched one
            self.batched_dispatches += 1
            if sharded:
                self.sharded_dispatches += 1
        dt = self.clock() - t0
        self.dispatches += 1
        for req, res in zip(reqs, results):
            req.result = res
            req.done = True
            req.dispatch_t = t0
            req.finish_t = t0 + dt
            req.batch_size = len(reqs)
        return dt
