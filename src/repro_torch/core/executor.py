"""Plan execution facade.

``execute`` lowers the logical plan by cost (repro_torch.core.lowering,
under the cost profile of the device it runs on) and runs the physical
operators (repro_torch.core.physical), on every call; ``compile_plan`` goes
through the compiled-plan cache (repro_torch.core.plan_cache), so
structurally repeated queries skip lowering and, on the card, replay one
captured CUDA graph.

``execute_reference`` keeps the per-node recursive interpreter over the
*logical* tree: the oracle for lowering-equivalence tests. It shares the
expression evaluator and the R3 realizations with the physical path; what
it does NOT share, and therefore what the equivalence tests check, is the
lowering, pipeline fusion, and side-table plumbing.

Both run on ``device`` (``cuda`` unless the caller names one; without CUDA
and without a device they raise) and move the catalog's tables there.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from repro_torch.core import cost, ir
from repro_torch.core import physical as ph
from repro_torch.core.evaluator import as_column, eval_expr
from repro_torch.core.lowering import lower
from repro_torch.core.plan_cache import GLOBAL_PLAN_CACHE, PlanCache
from repro_torch.kernels.common import resolve_device
from repro_torch.mlfuncs.registry import Registry
from repro_torch.relational import ops
from repro_torch.relational.table import Table


def _tables_on(catalog: ir.Catalog, device) -> Dict[str, Table]:
    dev = resolve_device(device)
    return {name: t.to(dev) for name, t in catalog.tables.items()}


# ---------------------------------------------------------------------------
# default path: lower + run physical
# ---------------------------------------------------------------------------

def execute(plan: ir.Plan, catalog: ir.Catalog, *,
            backend: Optional[str] = None, device=None) -> Table:
    dev = resolve_device(device)
    pplan = lower(plan, catalog, backend=backend,
                  profile=cost.default_profile(dev))
    return ph.run(pplan, _tables_on(catalog, dev))


def compile_plan(plan: ir.Plan, catalog: ir.Catalog,
                 cache: Optional[PlanCache] = None):
    """Returns a zero-arg callable over the catalog's tables.

    Compilation (lowering + capture) is shared through the plan cache
    (``GLOBAL_PLAN_CACHE``, on the card, unless ``cache`` is given); the
    returned closure re-reads ``catalog.tables`` on every call, so updated
    table contents (same schema/shapes) flow through without a recapture.
    """
    cache = cache or GLOBAL_PLAN_CACHE
    run = cache.get_or_compile(plan, catalog)
    return lambda: run(dict(catalog.tables))


# ---------------------------------------------------------------------------
# reference interpreter (logical tree, one dispatch per node)
# ---------------------------------------------------------------------------

def execute_node(node: ir.RelNode, catalog_tables: Dict[str, Table],
                 registry: Registry,
                 phys: Optional[Mapping[str, ir.PhysConfig]] = None) -> Table:
    phys = phys or {}
    if isinstance(node, ir.Scan):
        return catalog_tables[node.table]
    if isinstance(node, ir.Filter):
        t = execute_node(node.child, catalog_tables, registry, phys)
        mask = torch.as_tensor(eval_expr(node.pred, t, registry)).to(torch.bool)
        return ops.filter_(t, as_column(mask, t.capacity, t.device))
    if isinstance(node, ir.Compact):
        t = execute_node(node.child, catalog_tables, registry, phys)
        return ops.compact(t, node.capacity)
    if isinstance(node, ir.Project):
        t = execute_node(node.child, catalog_tables, registry, phys)
        new_cols = {name: as_column(eval_expr(e, t, registry), t.capacity, t.device)
                    for name, e in node.outputs}
        return ops.project(t, new_cols, keep=node.keep)
    if isinstance(node, ir.Join):
        lt = execute_node(node.left, catalog_tables, registry, phys)
        rt = execute_node(node.right, catalog_tables, registry, phys)
        return ops.fk_join(lt, rt, node.left_key, node.right_key, node.rprefix)
    if isinstance(node, ir.CrossJoin):
        lt = execute_node(node.left, catalog_tables, registry, phys)
        rt = execute_node(node.right, catalog_tables, registry, phys)
        return ops.cross_join(lt, rt, node.aprefix, node.bprefix)
    if isinstance(node, ir.Aggregate):
        t = execute_node(node.child, catalog_tables, registry, phys)
        return ops.aggregate(t, node.key, dict(node.aggs), node.num_groups)
    if isinstance(node, ir.BlockedMatmul):
        t = execute_node(node.child, catalog_tables, registry, phys)
        cfg = ir.resolve_phys(node, phys, registry)
        w = ph.matmul_weight(registry, node.fn, t.device)
        if cfg.mode == "relational":
            y = ph.blocked_matmul_relational(t, node.x_col, w, cfg.n_tiles)
        else:
            y = ph.blocked_matmul_fused(t[node.x_col], w, cfg.n_tiles,
                                        cfg.backend)
        return ops.project(t, {node.out_col: y}, keep=node.keep)
    if isinstance(node, ir.ForestRelational):
        t = execute_node(node.child, catalog_tables, registry, phys)
        cfg = ir.resolve_phys(node, phys, registry)
        fn = registry.get(node.fn)
        if cfg.mode == "relational":
            y = ph.forest_relational(t, node.x_col, fn)
        else:
            y = ph.forest_fused(t[node.x_col], fn, cfg.backend)
        return ops.project(t, {node.out_col: y}, keep=node.keep)
    raise TypeError(type(node))


def execute_reference(plan: ir.Plan, catalog: ir.Catalog, *,
                      device=None) -> Table:
    return execute_node(plan.root, _tables_on(catalog, device), plan.registry,
                        plan.phys)
