"""Serving tier: signature-grouped micro-batching over the compiled-plan cache.

The port of ``repro.serving``. In-flight ``(plan, tables)`` pairs enter
through ``QueryServer.submit``; the micro-batch scheduler (``MicroBatcher``)
groups them by their ``PlanCache.key()`` signature, and the batched
executor runs each group as one dispatch of the cached executable: the
stacked tables under ``torch.func.vmap``, one CUDA-graph replay on the card.
Given a mesh (``QueryServer(..., mesh=)``), eligible micro-batches are
instead split over the mesh's ranks (``backend="sharded"``), and a query
whose working set busts the per-device ``memory_budget`` runs partitioned
over them (see ``repro_torch.core.mesh``). Per-signature hit/latency
statistics flow back into ``ReusableMCTS`` warm-starts and the cost
profile's calibration through ``repro_torch.serving.feedback``.
"""
from repro_torch.serving.request import QueryRequest
from repro_torch.serving.batcher import MicroBatch, MicroBatcher
from repro_torch.serving.executor import BatchedExecutor
from repro_torch.serving.server import QueryServer, SignatureStats
from repro_torch.serving.feedback import SignatureExport, warm_start_from_server

__all__ = [
    "QueryRequest", "MicroBatch", "MicroBatcher", "BatchedExecutor",
    "QueryServer", "SignatureStats", "SignatureExport",
    "warm_start_from_server",
]
