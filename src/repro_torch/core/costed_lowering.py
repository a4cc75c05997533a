"""Costed lowering: pick the min-cost physical realization of a plan.

Phase 2 of the two-phase lowering pipeline: ``stage_graph.build`` (phase 1)
turns the logical plan into a stage-DAG of open decisions (stage order
within each fused pipeline, compaction placement after selective filters,
mode/backend realization per un-annotated ML node) and this module
enumerates the bounded candidate set and scores every realized candidate
through the *shared* cost oracle ``cost.plan_cost`` (the same entry point
the MCTS optimizers reward against; see ``planner.analytic_cost_fn``).

Enumeration is exhaustive over the cartesian product of site options while
it fits in ``max_candidates``; beyond that it falls back to deterministic
coordinate descent (two sweeps over the sites, committing the best option
of each site against the current best decisions). Deviating from the
tree-order default requires a *strictly* cheaper candidate, so plans the
oracle cannot separate keep the heuristic lowering (and its cache keys).

``choose_batch_realization`` is the same oracle applied to the serving
tier's batched-vs-sharded choice for one micro-batch.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import math
from typing import Dict, Optional

from repro_torch.core import cost, ir, stage_graph
from repro_torch.core import physical as ph

MAX_CANDIDATES = 64

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Lowered:
    """A costed lowering result: the chosen physical plan plus the decision
    vector that produced it (``signature`` is the plan-cache key part).

    ``budget_pruned`` counts candidates the per-device memory budget
    hard-rejected; ``budget_pruned_all`` is the misconfiguration flag:
    *every* scored candidate (including the partitioned ones) busted the
    budget and lowering fell back to tree order, so the chosen plan does
    NOT fit. Surfacing it here (plus a log line) keeps a too-small budget
    visible instead of silently degrading to arbitrary plans."""
    plan: ph.PhysicalPlan
    decisions: Dict[str, int]
    signature: str
    cost: float
    baseline_cost: float     # tree-order (heuristic) lowering, same oracle
    candidates_scored: int
    peak_memory: float = 0.0          # per-device, of the chosen plan
    memory_budget: Optional[float] = None
    budget_pruned: int = 0
    budget_pruned_all: bool = False


def lower_costed(plan: ir.Plan, catalog: ir.Catalog, *,
                 profile: Optional[cost.DeviceProfile] = None,
                 backend: Optional[str] = None,
                 memory_budget: Optional[float] = None,
                 max_candidates: int = MAX_CANDIDATES,
                 ways: int = 1) -> Lowered:
    """Min-cost lowering. ``ways > 1`` opens per-node PartSpec sites
    (intra-query sharding over a ``ways``-rank data mesh); ``profile``
    defaults to that of the device the catalog's tables live on;
    ``memory_budget`` (defaulting to the profile's per-device budget)
    hard-rejects any candidate whose ``phys_peak_memory`` exceeds it: the
    serving tier's admission path for oversized single queries."""
    profile = profile or cost.catalog_profile(catalog)
    if memory_budget is None:
        memory_budget = profile.memory_budget
    graph = stage_graph.build(plan, catalog, backend=backend, profile=profile,
                              ways=ways)
    pruned = {"n": 0}

    def score(d: Dict[str, int]) -> float:
        """Oracle cost, or +inf for candidates the memory budget rejects.
        The hard gate already walked the peak, so plan_cost gets an
        explicitly unlimited budget instead of re-walking it (its paging
        penalty could never fire on a candidate that passed the gate)."""
        pp = graph.realize(d)
        if memory_budget is not None:
            if cost.phys_peak_memory(pp, catalog, profile) > memory_budget:
                pruned["n"] += 1
                return math.inf
        return cost.plan_cost(pp, catalog, profile, memory_budget=math.inf)

    default = dict(graph.default_decisions())
    best = default
    base_cost = score(default)
    best_cost = base_cost
    scored = 1
    open_sites = [s for s in graph.sites.values() if len(s.options) > 1]
    if open_sites:
        if graph.n_candidates() <= max_candidates:
            fixed = {sid: 0 for sid, s in graph.sites.items()
                     if len(s.options) == 1}
            for combo in itertools.product(
                    *(range(len(s.options)) for s in open_sites)):
                d = dict(fixed)
                d.update({s.sid: c for s, c in zip(open_sites, combo)})
                if d == best and scored > 0:
                    continue  # default already scored
                c = score(d)
                scored += 1
                if c < best_cost:  # strict: ties keep the tree order
                    best, best_cost = d, c
        else:
            # deterministic coordinate descent, two sweeps. Under a memory
            # budget the all-replicated default can be infeasible while no
            # single-site flip is (partitioning one node just moves the
            # full-size boundary), so the maximally partitioned vector is
            # scored as a second seed and the descent starts from the
            # better of the two.
            if graph.ways > 1:
                seed = graph.partitioned_decisions()
                c = score(seed)
                scored += 1
                if c < best_cost:
                    best, best_cost = seed, c
            for _ in range(2):
                moved = False
                for site in open_sites:
                    for oi in range(len(site.options)):
                        if oi == best[site.sid]:
                            continue
                        d = dict(best)
                        d[site.sid] = oi
                        c = score(d)
                        scored += 1
                        if c < best_cost:
                            best, best_cost = d, c
                            moved = True
                if not moved:
                    break
    pruned_all = math.isinf(best_cost) and pruned["n"] > 0
    if pruned_all:
        # every candidate busts the budget: fall back to tree order, but
        # say so; a silent fallback reads as "this plan fits" when the
        # real story is a misconfigured (or genuinely impossible) budget
        best = default
        best_cost = cost.plan_cost(graph.realize(best), catalog, profile,
                                   memory_budget=memory_budget)
        logger.warning(
            "memory budget %.3g B pruned all %d scored lowering candidates "
            "(ways=%d); falling back to tree order, which does NOT fit",
            memory_budget, scored, graph.ways)
    chosen = graph.realize(best)
    return Lowered(plan=chosen, decisions=best,
                   signature=graph.decision_signature(best),
                   cost=best_cost,
                   baseline_cost=(base_cost if not math.isinf(base_cost)
                                  else best_cost),
                   candidates_scored=scored,
                   peak_memory=cost.phys_peak_memory(chosen, catalog,
                                                     profile),
                   memory_budget=memory_budget,
                   budget_pruned=pruned["n"],
                   budget_pruned_all=pruned_all)


def choose_batch_realization(plan: ir.Plan, catalog: ir.Catalog,
                             batch_size: int, mesh=None,
                             profile: Optional[cost.DeviceProfile] = None
                             ) -> str:
    """'sharded' or 'batched' for one eligible micro-batch, by the shared
    oracle: a ``ways``-way sharded dispatch runs each shard on the
    ``batch_size/ways`` slice (weights replicated) but pays the profile's
    per-shard collective overhead. Each side is priced at the realization
    it would actually run: the sharded path lowers every node to the ATen
    backend (``PLAN_LEVEL_BACKENDS``), so a kernel-annotated plan does not
    get kernel bandwidth credited to its sharded candidate. Ineligible
    meshes are always 'batched' (``core.mesh.can_shard`` is the legality
    gate, this is the cost gate)."""
    from repro_torch.core import mesh as mesh_util
    from repro_torch.core.lowering import lower

    if mesh is None or not mesh_util.can_shard(mesh, batch_size):
        return "batched"
    profile = profile or cost.catalog_profile(catalog)
    ways = mesh_util.batch_ways(mesh)
    pp_vmap = lower(plan, catalog, costed=False)
    pp_shard = lower(plan, catalog, costed=False, backend="sharded")
    c_vmap = cost.batched_plan_cost(pp_vmap, catalog, batch_size, profile)
    c_shard = cost.batched_plan_cost(pp_shard, catalog, batch_size, profile,
                                     ways=ways)
    return "sharded" if c_shard <= c_vmap else "batched"
