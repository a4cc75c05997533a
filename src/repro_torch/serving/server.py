"""QueryServer: the serving tier's front-end.

``submit`` admits an in-flight ``(plan, tables)`` pair asynchronously (it
returns a pending ``QueryRequest`` immediately); ``step`` lets the
micro-batch scheduler dispatch every signature group that hit its admission
policy; ``drain`` flushes the rest. Per-signature traffic statistics
(request counts, batch occupancy, dispatch latency) accumulate in
``SignatureStats`` and are exported to the optimizer-feedback channel by
``repro_torch.serving.feedback``.

The server runs on ``device`` (its cache's; ``cuda`` unless the caller
names one). The clock is injectable (``clock=``) so schedulers and tests
can drive deadlines deterministically; the default is ``time.monotonic``.

With a ``mesh`` every rank of it runs the same server and submits the same
traffic (multi-controller). Eligible micro-batches are sharded over the
mesh, and a submitted plan whose working set busts the per-device
``memory_budget`` is routed to the partitioned executable. Each route is a
sequence of collectives, so the ranks must dispatch the same batches by
the same routes; a wall-clock batching window would differ between them.
So rank 0 forms each step's micro-batches and picks their routes, and
broadcasts both before the dispatch: the one decision the reference's
single controller makes. A batch that fails on one device fails its own
requests; on a mesh of several ranks the failure raises, so that a fault
on any rank stops the run instead of leaving the others in a collective.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Dict, Optional

from repro_torch.core import cost as cost_mod
from repro_torch.core import ir
from repro_torch.core import mesh as mesh_util
from repro_torch.core.plan_cache import LRUCache, PlanCache, scan_table_names
from repro_torch.relational.table import Table
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.executor import BatchedExecutor
from repro_torch.serving.request import QueryRequest


@dataclasses.dataclass
class SignatureStats:
    """Per-signature serving statistics (the feedback channel's payload)."""
    key: str
    requests: int = 0               # everything submitted, incl. pending
    served_requests: int = 0        # successfully dispatched requests only
    dispatches: int = 0
    batched_requests: int = 0       # requests served in a batch of >= 2
    sharded_dispatches: int = 0     # dispatches served multi-rank (batch
    partitioned_dispatches: int = 0  # axis sharded / operators partitioned)
    ways: int = 0                   # mesh rank count of those dispatches
    failures: int = 0               # requests whose dispatch raised
    total_dispatch_s: float = 0.0
    total_wait_s: float = 0.0
    # representative query for this signature: lets the feedback channel
    # re-optimize what the serving tier actually sees most
    plan: Optional[ir.Plan] = None
    catalog: Optional[ir.Catalog] = None

    @property
    def mean_occupancy(self) -> float:
        # served / dispatches: pending submissions and failed batches never
        # rode a dispatch, so counting them (as `requests` would) inflates
        # the occupancy the MCTS feedback channel prioritizes by
        return (self.served_requests / self.dispatches
                if self.dispatches else 0.0)

    @property
    def mean_dispatch_s(self) -> float:
        return (self.total_dispatch_s / self.dispatches
                if self.dispatches else 0.0)

    @property
    def mean_wait_s(self) -> float:
        """Mean queueing delay (submit -> dispatch) of served requests: the
        admission-policy pressure signal warm-start prioritization reads."""
        return (self.total_wait_s / self.served_requests
                if self.served_requests else 0.0)

    def as_dict(self) -> Dict[str, float]:
        return {"requests": self.requests,
                "served_requests": self.served_requests,
                "dispatches": self.dispatches,
                "batched_requests": self.batched_requests,
                "sharded_dispatches": self.sharded_dispatches,
                "partitioned_dispatches": self.partitioned_dispatches,
                "ways": self.ways,
                "mean_occupancy": self.mean_occupancy,
                "mean_dispatch_s": self.mean_dispatch_s,
                "mean_wait_s": self.mean_wait_s}


class QueryServer:
    def __init__(self, cache: Optional[PlanCache] = None,
                 max_batch_size: int = 8, max_wait_s: float = 2e-3,
                 backend: Optional[str] = None, mesh=None,
                 memory_budget: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic, device=None):
        self.cache = cache or PlanCache(device=device)
        self.cache.device  # resolved here: no CUDA and no device raises
        self.batcher = MicroBatcher(max_batch_size=max_batch_size,
                                    max_wait_s=max_wait_s)
        # mesh: multi-rank batch sharding; eligible micro-batches take
        # the backend="sharded" executable (see BatchedExecutor.route)
        self.executor = BatchedExecutor(self.cache, backend=backend,
                                        mesh=mesh, clock=clock)
        self.mesh = mesh
        self._ways = mesh_util.batch_ways(mesh) if mesh is not None else 1
        # per-device working-set budget: installed on the cache's profile,
        # so every costed-lowering decision this server triggers sees it.
        # A submitted plan that busts it is routed to the *partitioned*
        # executable (operators sharded over the mesh) instead of being
        # served on one device (thrashing) or refused.
        if memory_budget is not None:
            self.cache.profile.memory_budget = float(memory_budget)
        self.clock = clock
        self.signatures: Dict[str, SignatureStats] = {}
        self.completed = 0
        self.failed = 0
        self._next_rid = 0
        # memoizes (key, scanned names) per (plan, catalog) object identity:
        # parameterized traffic re-submits the same plan objects, and the
        # full signature walk is too expensive for the per-request path.
        # Entries hold weakrefs (a live ref pins the id; a dead ref or an
        # identity mismatch is a miss), so the memo never keeps retired
        # plans or their catalogs' table payloads alive.
        self._submit_memo = LRUCache(maxsize=1024)

    # -- admission ---------------------------------------------------------
    def submit(self, plan: ir.Plan, catalog: ir.Catalog,
               tables: Optional[Dict[str, Table]] = None) -> QueryRequest:
        """Admit one in-flight query; returns immediately with a pending
        request whose ``result`` is filled by a later ``step``/``drain``."""
        if tables is None:
            tables = dict(catalog.tables)
        memo = self._submit_memo.get((id(plan), id(catalog)))
        if memo is not None and (memo[0]() is not plan
                                 or memo[1]() is not catalog
                                 # a recalibrated profile can change the
                                 # key's lowering-decision suffix: a stale
                                 # memo must not alias the old executable
                                 or memo[4] != self.cache.profile_epoch):
            memo = None  # id was reused by a different object
        if memo is None:
            # oversized single query: a working set over the per-device
            # budget can't be served on one device; key it (and flag it)
            # for the partitioned executable, whose PartSpec vector rides
            # the key's #cl= decision tokens
            budget = self.cache.profile.memory_budget
            partitioned = (
                self._ways > 1 and budget is not None
                and cost_mod.plan_peak_memory(plan, catalog,
                                              self.cache.profile) > budget)
            key = (self.cache.key(plan, catalog, mesh=self.mesh,
                                  backend=self.executor.backend)
                   if partitioned else self.cache.key(plan, catalog))
            memo = (weakref.ref(plan), weakref.ref(catalog), key,
                    scan_table_names(plan), self.cache.profile_epoch,
                    partitioned)
            self._submit_memo.put((id(plan), id(catalog)), memo)
        _, _, key, scanned, _, partitioned = memo
        # ship only the tables the plan scans: the batched executor stacks
        # every leaf of every request, so catalog tables the query never
        # touches would be pure copy overhead on the dispatch path
        req = QueryRequest(rid=self._next_rid, plan=plan, catalog=catalog,
                           tables={k: tables[k] for k in scanned},
                           key=key, submit_t=self.clock(),
                           partitioned=partitioned)
        self._next_rid += 1
        sig = self.signatures.get(req.key)
        if sig is None:
            sig = self.signatures[req.key] = SignatureStats(
                key=req.key, plan=plan, catalog=catalog)
        sig.requests += 1
        self.batcher.add(req)
        return req

    # -- dispatch ----------------------------------------------------------
    def step(self) -> int:
        """Dispatch every signature group that satisfies the admission
        policy (size cap reached or wait deadline expired). Returns the
        number of requests completed this step."""
        return self._dispatch(self._decide(lambda: self.batcher.pop_ready(self.clock())))

    def drain(self) -> int:
        """Flush all pending requests regardless of deadlines."""
        return self._dispatch(self._decide(self.batcher.pop_all))

    def _decide(self, pop):
        """The micro-batches to dispatch now and their routes. On a mesh of
        several ranks rank 0 pops and routes them and broadcasts the
        decision (keys, request ids, routes); the other ranks take exactly
        those requests from their own scheduler."""
        if self._ways <= 1:
            return [(b, self.executor.route(b)) for b in pop()]
        first = mesh_util.rank_of(self.mesh) == 0
        decision = None
        if first:
            batches = pop()
            decision = [(b.key, [r.rid for r in b.requests], self.executor.route(b))
                        for b in batches]
        decision = mesh_util.broadcast_from_first(decision, self.mesh)
        if not first:
            batches = [self.batcher.take(key, rids) for key, rids, _ in decision]
        return [(b, route) for b, (_, _, route) in zip(batches, decision)]

    def _dispatch(self, routed) -> int:
        done = 0
        for batch, route in routed:
            sig = self.signatures[batch.key]
            try:
                dt = self.executor.dispatch(batch, route)
            except Exception as e:  # noqa: BLE001 — a bad payload (e.g.
                # tables whose shapes disagree with the signature's schema)
                # must fail its own batch, not hang its requests forever or
                # take the serving loop down with them. On a mesh of several
                # ranks it raises: the other ranks may wait in a collective
                # this rank will not enter, and going on would put the
                # ranks' collectives out of step
                if self._ways > 1:
                    raise
                now = self.clock()
                for req in batch.requests:
                    req.done = True
                    req.error = f"{type(e).__name__}: {e}"
                    req.dispatch_t = req.finish_t = now
                sig.failures += len(batch)
                self.failed += len(batch)
                continue
            sig.dispatches += 1
            sig.served_requests += len(batch)
            sig.total_dispatch_s += dt
            if batch.sharded:
                sig.sharded_dispatches += 1
                sig.ways = self._ways
            if batch.partitioned:
                sig.partitioned_dispatches += 1
                sig.ways = self._ways
            for req in batch.requests:
                sig.total_wait_s += req.queue_wait_s
                if req.batch_size >= 2:
                    sig.batched_requests += 1
            done += len(batch)
        self.completed += done
        return done

    # -- introspection -----------------------------------------------------
    def pending(self) -> int:
        return self.batcher.pending()

    def stats(self) -> Dict[str, float]:
        sigs = self.signatures.values()
        total_disp = sum(s.dispatches for s in sigs)
        return {
            "completed": self.completed,
            "failed": self.failed,
            "pending": self.batcher.pending(),
            "signatures": len(self.signatures),
            "groups_formed": self.batcher.groups_formed,
            "dispatches": total_disp,
            "sharded_dispatches": self.executor.sharded_dispatches,
            "partitioned_dispatches": self.executor.partitioned_dispatches,
            "mean_occupancy": (self.completed / total_disp
                               if total_disp else 0.0),
            "cache": self.cache.stats.as_dict(),
            "traces": self.cache.traces,
        }
