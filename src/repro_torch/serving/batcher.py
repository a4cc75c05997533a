"""Micro-batch scheduler: group pending requests by plan signature.

Admission policy (in the spirit of ``launch/serve.py``'s continuous-batching
loop): a signature group is dispatched as soon as it reaches
``max_batch_size`` requests, or once its oldest member has waited
``max_wait_s`` — whichever comes first. Bounded wait keeps tail latency
proportional to the wait budget; bounded size keeps the set of distinct
vmapped executables (one per batch size, see
``PlanCache.get_or_compile_batched``) small.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Deque, Dict, List

from repro_torch.serving.request import QueryRequest


@dataclasses.dataclass
class MicroBatch:
    """One dispatchable group of same-signature requests."""
    key: str
    requests: List[QueryRequest]
    # realization the executor actually served this batch with (stamped by
    # BatchedExecutor.dispatch; the server folds them into SignatureStats)
    sharded: bool = False
    partitioned: bool = False

    def __len__(self) -> int:
        return len(self.requests)


@dataclasses.dataclass
class _Group:
    requests: Deque[QueryRequest]

    @property
    def oldest_t(self) -> float:
        return self.requests[0].submit_t


class MicroBatcher:
    def __init__(self, max_batch_size: int = 8, max_wait_s: float = 2e-3):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_s
        self._groups: "OrderedDict[str, _Group]" = OrderedDict()
        self.groups_formed = 0          # micro-batches dispatched so far
        self.requests_admitted = 0

    # -- admission ---------------------------------------------------------
    def add(self, req: QueryRequest) -> None:
        group = self._groups.get(req.key)
        if group is None:
            group = self._groups[req.key] = _Group(requests=deque())
        group.requests.append(req)
        self.requests_admitted += 1

    def pending(self) -> int:
        return sum(len(g.requests) for g in self._groups.values())

    # -- dispatch decisions ------------------------------------------------
    def pop_ready(self, now: float) -> List[MicroBatch]:
        """Groups that hit the size cap or exceeded the wait deadline.

        A group larger than ``max_batch_size`` is split; the remainder keeps
        its arrival order and original timestamps (so its own deadline still
        counts from the oldest left-behind request).
        """
        ready: List[MicroBatch] = []
        for key in list(self._groups):
            group = self._groups[key]
            while len(group.requests) >= self.max_batch_size:
                ready.append(self._take(key, group, self.max_batch_size))
            if group.requests and now - group.oldest_t >= self.max_wait_s:
                ready.append(self._take(key, group, len(group.requests)))
            if not group.requests:
                del self._groups[key]
        return ready

    def pop_all(self) -> List[MicroBatch]:
        """Flush everything regardless of deadlines (server drain)."""
        ready: List[MicroBatch] = []
        for key in list(self._groups):
            group = self._groups[key]
            while group.requests:
                ready.append(self._take(key, group,
                                        min(len(group.requests),
                                            self.max_batch_size)))
            del self._groups[key]
        return ready

    def take(self, key: str, rids) -> MicroBatch:
        """The requests ``rids`` of the ``key`` group, as one micro-batch in
        the given order: a batch that another rank's scheduler formed (the
        server on a mesh follows rank 0's decisions). Raises if any is not
        pending here."""
        group = self._groups.get(key)
        pending = {r.rid: r for r in group.requests} if group is not None else {}
        missing = [rid for rid in rids if rid not in pending]
        if missing:
            raise RuntimeError(f"requests {missing} of {key[:60]!r} are not pending "
                               "here: the ranks were submitted different traffic")
        chosen = set(rids)
        group.requests = deque(r for r in group.requests if r.rid not in chosen)
        if not group.requests:
            del self._groups[key]
        self.groups_formed += 1
        return MicroBatch(key=key, requests=[pending[rid] for rid in rids])

    def _take(self, key: str, group: _Group, n: int) -> MicroBatch:
        batch = MicroBatch(key=key,
                           requests=[group.requests.popleft() for _ in range(n)])
        self.groups_formed += 1
        return batch
