"""In-flight query requests: the unit the serving tier admits and batches.

A ``QueryRequest`` is one ``(plan, tables)`` pair plus bookkeeping. The
``tables`` payload defaults to the catalog's own tables but is usually a
fresh same-schema dict: the parameterized-traffic case the compiled-plan
cache exists for. Requests with equal signature keys (``PlanCache.key``)
share one compiled executable and may be vmapped together.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import ir
from repro_torch.relational.table import Table


@dataclasses.dataclass
class QueryRequest:
    rid: int
    plan: ir.Plan
    catalog: ir.Catalog
    tables: Dict[str, Table]
    key: str = ""                   # PlanCache signature (set by the server)
    submit_t: float = 0.0           # server-clock timestamps
    dispatch_t: float = 0.0
    finish_t: float = 0.0
    batch_size: int = 0             # occupancy of the batch that served it
    # oversized single query: its plan's working set busts the per-device
    # memory budget, so it is keyed and served through the *partitioned*
    # executable (PlanCache.get_or_compile_partitioned) instead of being
    # refused or thrashing a single device
    partitioned: bool = False
    result: Optional[Table] = None
    done: bool = False
    error: Optional[str] = None     # set instead of result if dispatch failed

    @property
    def queue_wait_s(self) -> float:
        return max(0.0, self.dispatch_t - self.submit_t)

    @property
    def latency_s(self) -> float:
        return max(0.0, self.finish_t - self.submit_t)
