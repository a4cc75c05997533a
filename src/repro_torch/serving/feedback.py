"""Feedback channel: serving-tier signature statistics -> optimizer warm-starts
and cost-oracle calibration (the port of ``repro.serving.feedback``).

Closes the ROADMAP loop "feed cache hit statistics back into ReusableMCTS
warm-starts": the signatures the server actually sees — weighted by traffic
volume x dispatch latency, i.e. where optimization time pays off — are
re-optimized once against their representative plan. Each such run
populates the optimizer's embedding-keyed global node store
(``core/mcts.py`` ``NodeIndex``), so the *next* query of that family
(including parameter variants whose exact signature differs but whose
Query2Vec embedding collides) starts from a warm root and needs only
``warm_iterations`` instead of a cold full search.

The same statistics also sharpen the *analytic* oracle online:
``calibrate_profile`` least-squares-fits the device profile's
``peak_flops`` / ``hbm_bw`` / ``op_overhead_s`` against measured
per-signature dispatch latencies (via ``cost.plan_cost_breakdown``'s
linearized predictions), and ``apply_calibration`` installs the fitted
profile into a ``PlanCache`` — whose costed lowering then re-derives its
decisions under the new profile (``PlanCache.recalibrate`` bumps the
profile epoch, so a changed decision selects a fresh executable instead of
aliasing a stale one). Serving traffic thereby sharpens future lowering
decisions. On the card this is how the H100 prior's ``op_overhead_s`` is
meant to be replaced by a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import cost, ir
from repro_torch.core.mcts import ReusableMCTS
from repro_torch.core.plan_cache import PlanCache
from repro_torch.serving.server import QueryServer


@dataclasses.dataclass
class SignatureExport:
    """One serving signature's traffic summary, with its representative
    query attached so the optimizer can replay it."""
    key: str
    requests: int
    dispatches: int
    mean_occupancy: float
    mean_dispatch_s: float
    # mean queueing delay (submit -> dispatch): signatures under batching
    # pressure wait longer, which warm-start prioritization should see
    mean_wait_s: float
    plan: ir.Plan
    catalog: ir.Catalog
    # multi-device traffic: how many dispatches ran sharded/partitioned and
    # over how many devices — the calibration features of the profile's
    # collective_overhead_s (single-device signatures leave them 0)
    sharded_dispatches: int = 0
    partitioned_dispatches: int = 0
    ways: int = 0

    @property
    def weight(self) -> float:
        """Traffic volume x unit latency (dispatch + queueing): expected
        user-visible seconds this signature costs the fleet, the natural
        priority for optimizer attention. Queueing pressure counts — a
        signature whose requests sit in the batcher is hurting tail latency
        even when its dispatches are cheap."""
        return self.requests * max(self.mean_dispatch_s + self.mean_wait_s,
                                   1e-9)


def export_signature_stats(server: QueryServer) -> List[SignatureExport]:
    """Snapshot the server's per-signature stats, heaviest traffic first."""
    exports = [
        SignatureExport(key=s.key, requests=s.requests,
                        dispatches=s.dispatches,
                        mean_occupancy=s.mean_occupancy,
                        mean_dispatch_s=s.mean_dispatch_s,
                        mean_wait_s=s.mean_wait_s,
                        plan=s.plan, catalog=s.catalog,
                        sharded_dispatches=s.sharded_dispatches,
                        partitioned_dispatches=s.partitioned_dispatches,
                        ways=s.ways)
        for s in server.signatures.values()
        if s.plan is not None and s.dispatches > 0
    ]
    exports.sort(key=lambda e: -e.weight)
    return exports


def warm_start_from_server(mcts: ReusableMCTS,
                           exports: List[SignatureExport],
                           top_k: int = 4) -> Dict[str, object]:
    """Prime the reusable optimizer's node store from server traffic.

    Runs one full optimization per hot signature (heaviest ``top_k`` by
    ``weight``). The visits land in the shared ``NodeIndex``-backed store,
    so subsequent same-family queries collide with a well-visited root and
    take the warm path (fewer iterations, exploit known-good actions first).
    Returns a summary of what was primed.
    """
    primed = []
    for e in exports[:top_k]:
        _, stats = mcts.optimize(e.plan, e.catalog)
        primed.append({"key": e.key, "requests": e.requests,
                       "weight": e.weight,
                       "best_cost": stats["best_cost"],
                       "iterations": stats["iterations"]})
    return {"primed": primed, "store_nodes": len(mcts.nodes),
            "store_bytes": mcts.storage_bytes()}


# ---------------------------------------------------------------------------
# analytic-oracle calibration from measured dispatch latencies
# ---------------------------------------------------------------------------

def calibrate_profile(exports: List[SignatureExport],
                      profile: Optional[cost.DeviceProfile] = None,
                      *, l2: float = 0.1) -> cost.CalibrationFit:
    """Refit the device profile against measured serving latencies.

    Each served signature contributes one sample: the analytic resource
    breakdown of its representative plan scaled to the signature's mean
    batch occupancy (data traffic and FLOPs ride the batch axis, weights
    stream once per dispatch) against its measured mean dispatch seconds,
    weighted by dispatch count. Signatures whose dispatches ran
    predominantly multi-device (sharded batch axis or partitioned
    operators) are modeled like ``cost.batched_plan_cost`` models them:
    per-shard data scale ``occupancy / ways`` plus ``ways`` collective
    launches — which is what identifies ``collective_overhead_s``
    alongside ``peak_flops`` / ``hbm_bw`` / ``op_overhead_s`` (an all-zero
    ``n_coll`` column leaves it at the prior). The fit solves the
    four-coefficient system with a ridge pull toward the prior — see
    ``cost.fit_profile``.
    """
    profile = profile or cost.default_profile()  # the card's, without one
    samples = []
    for e in exports:
        if e.dispatches <= 0 or e.mean_dispatch_s <= 0:
            continue
        b = cost.plan_cost_breakdown(e.plan, e.catalog, profile)
        multi = e.sharded_dispatches + e.partitioned_dispatches
        ways = e.ways if (e.ways > 1 and 2 * multi >= e.dispatches) else 1
        sample = b.scaled(max(e.mean_occupancy, 1.0) / ways)
        if ways > 1:
            sample = dataclasses.replace(sample,
                                         n_coll=sample.n_coll + float(ways))
        samples.append((sample, e.mean_dispatch_s, float(e.dispatches)))
    return cost.fit_profile(samples, profile, l2=l2)


def apply_calibration(cache: PlanCache, exports: List[SignatureExport],
                      *, l2: float = 0.1) -> cost.CalibrationFit:
    """Calibrate against the cache's current profile and install the fit.

    ``PlanCache.recalibrate`` bumps the profile epoch: every signature's
    lowering decisions are re-derived on its next dispatch, and a changed
    realization vector changes the executable key — serving traffic
    sharpens future lowering decisions without stale-executable aliasing.
    """
    fit = calibrate_profile(exports, cache.profile, l2=l2)
    if fit.n_samples:
        cache.recalibrate(fit.profile)
    return fit
