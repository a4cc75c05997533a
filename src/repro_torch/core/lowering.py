"""Lowering pass: logical Plan -> PhysicalPlan.

By default lowering is *cost-driven* (``costed=True``): the plan becomes a
stage-DAG of candidate decisions (``core.stage_graph``) and
``core.costed_lowering`` picks the min-cost physical realization through
the shared ``cost.plan_cost`` oracle. The tree-order heuristic below
(``costed=False``) remains the baseline: realization choices come from the
plan's physical side table (``plan.phys``, keyed by node uid); nodes without an annotation
get ``ir.DEFAULT_PHYS`` with the tile count sized from the weight (the same
policy R3-1 uses when it annotates). Adjacent row-local operators (Filter,
Project, Compact) fuse into a single ``PPipeline`` stage chain: one driver
per pipeline instead of one interpreter dispatch per logical node.

``backend`` overrides every annotation's backend ('torch' forces ATen ops,
'kernel' the hand-written kernels) without touching the plan: the paper's
"re-realize without touching the logical query" knob. ``backend="sharded"``
is the multi-device realization: per node it resolves to the ATen path
(each rank runs an ordinary single-device program on its slice of the
stacked batch axis; see ``PlanCache.get_or_compile_sharded``), while the
choice itself stays first-class in compiled-plan cache keys.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import ir
from repro_torch.core import physical as ph


# plan-level realizations and the node-level backend they resolve to: the
# sharded path splits the stacked batch axis *around* the plan body, so each
# rank's slice runs the ordinary ATen program
_PLAN_LEVEL_BACKENDS = {"sharded": "torch"}


def _config(plan: ir.Plan, node: ir.RelNode,
            backend: Optional[str]) -> ir.PhysConfig:
    cfg = plan.phys_for(node)  # resolves the weight-derived n_tiles default
    if backend is not None:
        backend = _PLAN_LEVEL_BACKENDS.get(backend, backend)
        cfg = ir.PhysConfig(mode=cfg.mode, backend=backend, n_tiles=cfg.n_tiles)
    return cfg


_ROW_LOCAL = (ir.Filter, ir.Project, ir.Compact)


def _as_stage(node: ir.RelNode) -> ph.Stage:
    if isinstance(node, ir.Filter):
        return ph.FilterStage(pred=node.pred)
    if isinstance(node, ir.Project):
        return ph.ProjectStage(outputs=node.outputs, keep=node.keep)
    if isinstance(node, ir.Compact):
        return ph.CompactStage(capacity=node.capacity)
    raise TypeError(type(node))


def _lower_node(node: ir.RelNode, plan: ir.Plan,
                backend: Optional[str]) -> ph.PhysNode:
    if isinstance(node, _ROW_LOCAL):
        # collect the maximal Filter/Project/Compact chain (Velox-style
        # pipeline); stages execute source-to-sink, so reverse the walk
        stages: list = []
        cur = node
        while isinstance(cur, _ROW_LOCAL):
            stages.append(_as_stage(cur))
            cur = cur.children()[0]
        return ph.PPipeline(child=_lower_node(cur, plan, backend),
                            stages=tuple(reversed(stages)))
    if isinstance(node, ir.Scan):
        return ph.PScan(table=node.table)
    if isinstance(node, ir.Join):
        return ph.PJoin(left=_lower_node(node.left, plan, backend),
                        right=_lower_node(node.right, plan, backend),
                        left_key=node.left_key, right_key=node.right_key,
                        rprefix=node.rprefix)
    if isinstance(node, ir.CrossJoin):
        return ph.PCrossJoin(left=_lower_node(node.left, plan, backend),
                             right=_lower_node(node.right, plan, backend),
                             aprefix=node.aprefix, bprefix=node.bprefix)
    if isinstance(node, ir.Aggregate):
        return ph.PAggregate(child=_lower_node(node.child, plan, backend),
                             key=node.key, aggs=node.aggs,
                             num_groups=node.num_groups)
    if isinstance(node, ir.BlockedMatmul):
        cfg = _config(plan, node, backend)
        return ph.PBlockedMatmul(
            child=_lower_node(node.child, plan, backend),
            x_col=node.x_col, out_col=node.out_col, fn=node.fn,
            n_tiles=cfg.n_tiles, mode=cfg.mode, backend=cfg.backend,
            keep=node.keep)
    if isinstance(node, ir.ForestRelational):
        cfg = _config(plan, node, backend)
        return ph.PForestRelational(
            child=_lower_node(node.child, plan, backend),
            x_col=node.x_col, out_col=node.out_col, fn=node.fn,
            mode=cfg.mode, backend=cfg.backend, keep=node.keep)
    raise TypeError(type(node))


def lower(plan: ir.Plan, catalog: ir.Catalog, *,
          backend: Optional[str] = None, costed: bool = True,
          profile=None, memory_budget: Optional[float] = None,
          ways: int = 1) -> ph.PhysicalPlan:
    """Lower a logical plan to its physical realization.

    By default lowering is *cost-driven*: the min-cost realization under the
    shared analytic oracle (``core.costed_lowering`` / ``cost.plan_cost``),
    with ``catalog`` supplying the statistics those decisions need and
    ``profile`` (default: that of the catalog's device) and
    ``memory_budget`` parameterizing the oracle. ``costed=False`` keeps the
    tree-order heuristic (one stage per logical node, pipelines fused in
    tree order), which is also the costed path's baseline and the shape
    ``plan_cost`` assumes when costing a *logical* plan. ``backend``
    force-overrides every node's backend annotation in either mode.
    ``ways > 1`` (costed only) opens per-node ``PartSpec`` candidates:
    intra-query sharding over a ``ways``-rank data mesh, with explicit
    ``PRepartition`` boundaries; the resulting plan must run on every rank
    of the mesh (``PlanCache.get_or_compile_partitioned``).
    """
    if costed:
        from repro_torch.core.costed_lowering import lower_costed
        return lower_costed(plan, catalog, backend=backend, profile=profile,
                            memory_budget=memory_budget, ways=ways).plan
    root = _lower_node(plan.root, plan, backend)
    return ph.PhysicalPlan(root=root, registry=plan.registry)
