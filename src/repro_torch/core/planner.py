"""Optimizer strategies compared in the paper (Sec. V-B "baselines"):
Un-optimized / Arbitrary / Heuristic / Vanilla MCTS / Reusable MCTS.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import ir
from repro_torch.core.cost import DeviceProfile, catalog_profile, plan_cost
from repro_torch.core.mcts import (ACTION_SPACE, VanillaMCTS, ReusableMCTS,
                             configure_action)
from repro_torch.core.rules import ALL_RULES


def analytic_cost_fn(catalog: ir.Catalog, profile: DeviceProfile | None = None,
                     memory_budget: float | None = None) -> Callable:
    """The MCTS/greedy reward oracle: the same ``plan_cost`` entry point
    costed lowering scores its candidates with, against the profile of the
    device the catalog's tables live on unless one is given: one notion of
    "cheap" across optimizer and executor."""
    profile = profile or catalog_profile(catalog)

    def cost(plan: ir.Plan) -> float:
        return plan_cost(plan, catalog, profile, memory_budget=memory_budget)

    return cost


def optimize_none(plan: ir.Plan, catalog: ir.Catalog, **kw) -> Tuple[ir.Plan, Dict]:
    return plan, {"strategy": "unoptimized"}


def optimize_arbitrary(plan: ir.Plan, catalog: ir.Catalog, max_apps: int = 30,
                       **kw) -> Tuple[ir.Plan, Dict]:
    """Paper: 'scans all co-optimization rules and applies all applicable
    rules' — no cost model, fixed scan order."""
    apps = 0
    for action in ACTION_SPACE:
        rule = ALL_RULES[action]
        for _ in range(4):
            cfgs = rule.configs(plan, catalog)
            if not cfgs or apps >= max_apps:
                break
            try:
                plan = rule.apply(plan, catalog, cfgs[0])
                apps += 1
            except Exception:
                break
    return plan, {"strategy": "arbitrary", "applications": apps}


def optimize_heuristic(plan: ir.Plan, catalog: ir.Catalog,
                       memory_budget: float = 512e6, **kw) -> Tuple[ir.Plan, Dict]:
    """Paper heuristic baseline: (1) aggressively push down filters/projects;
    (2) aggressively fuse ML operators; (3) tensor-relational transforms only
    for models larger than half the memory budget."""
    apps = 0
    # (1) pushdown + compaction to a fixpoint
    for _ in range(40):
        moved = False
        for action in ("R1-2", "R1-3", "compact"):
            rule = ALL_RULES[action]
            cfgs = rule.configs(plan, catalog)
            if cfgs:
                plan = rule.apply(plan, catalog, cfgs[0])
                apps += 1
                moved = True
                break
        if not moved:
            break
    # (2) fuse everything fusable
    rule = ALL_RULES["R4-1-fuse"]
    for _ in range(20):
        cfgs = rule.configs(plan, catalog)
        if not cfgs:
            break
        plan = rule.apply(plan, catalog, cfgs[0])
        apps += 1
    # (3) R3-1 for big tensors only
    rule = ALL_RULES["R3-1"]
    for _ in range(8):
        cfgs = [c for c in rule.configs(plan, catalog)
                if plan.registry.get(c.get("fn")).graph.nodes[c.get("idx")]
                .atom.param_bytes() > memory_budget / 2]
        if not cfgs:
            break
        plan = rule.apply(plan, catalog, cfgs[0])
        apps += 1
    return plan, {"strategy": "heuristic", "applications": apps}


def optimize_greedy(plan: ir.Plan, catalog: ir.Catalog,
                    cost_fn: Optional[Callable] = None, max_steps: int = 12,
                    **kw) -> Tuple[ir.Plan, Dict]:
    """Cost-model hill-climbing over configured actions (extra baseline)."""
    cost_fn = cost_fn or analytic_cost_fn(catalog)
    cur_cost = cost_fn(plan)
    for _ in range(max_steps):
        best, best_cost = None, cur_cost
        for action in ACTION_SPACE:
            res = configure_action(plan, catalog, action, cost_fn)
            if res is None:
                continue
            cand, _ = res
            c = cost_fn(cand)
            if c < best_cost:
                best, best_cost = cand, c
        if best is None:
            break
        plan, cur_cost = best, best_cost
    return plan, {"strategy": "greedy", "cost": cur_cost}


def optimize_vanilla_mcts(plan: ir.Plan, catalog: ir.Catalog,
                          cost_fn: Optional[Callable] = None,
                          iterations: int = 40, seed: int = 0,
                          **kw) -> Tuple[ir.Plan, Dict]:
    cost_fn = cost_fn or analytic_cost_fn(catalog)
    m = VanillaMCTS(catalog, cost_fn, iterations=iterations, seed=seed)
    out, stats = m.optimize(plan)
    stats["strategy"] = "vanilla_mcts"
    return out, stats


def timed(fn, plan, catalog, **kw):
    t0 = time.perf_counter()
    out, stats = fn(plan, catalog, **kw)
    stats["opt_seconds"] = time.perf_counter() - t0
    return out, stats


STRATEGIES = {
    "unoptimized": optimize_none,
    "arbitrary": optimize_arbitrary,
    "heuristic": optimize_heuristic,
    "greedy": optimize_greedy,
    "vanilla_mcts": optimize_vanilla_mcts,
}
