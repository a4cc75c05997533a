"""O1 — relational algebra optimization (ML as opaque UDFs).

R1-1 filter reorder, R1-2 filter pushdown, R1-3 project pushdown,
R1-4 merge/split, plus the physical ``compact`` action that makes pushdowns
pay: every operator runs over a table's full capacity, so shrinking the
capacity after a selective filter shrinks all the work downstream.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core import evaluator, ir
from repro_torch.core.rules import base
from repro_torch.core.rules.base import Rule, RuleConfig, register_rule


def _side_schemas(node, registry, catalog):
    li = ir.infer(node.left, registry, catalog)
    ri = ir.infer(node.right, registry, catalog)
    return li.schema, ri.schema


def _prefixes(node):
    if isinstance(node, ir.Join):
        return "", node.rprefix
    return node.aprefix, node.bprefix


def _strip_prefix(e: ir.Expr, prefix: str) -> ir.Expr:
    if not prefix:
        return e
    mapping = {}
    for c in e.cols():
        if c.startswith(prefix):
            mapping[c] = ir.Col(c[len(prefix):])
    return base.subst_cols(e, mapping)


@register_rule
class FilterReorder(Rule):
    """R1-1: swap two adjacent filters (cheap/selective first)."""
    name = "R1-1"
    category = "O1"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if isinstance(n, ir.Filter) and isinstance(n.child, ir.Filter):
                out.append(RuleConfig.make(self.name, path=p))
        return out

    def apply(self, plan, catalog, cfg):
        p = cfg.get("path")
        outer = base.node_at(plan.root, p)
        inner = outer.child
        new = dataclasses.replace(
            inner, child=dataclasses.replace(outer, child=inner.child))
        return plan.replace_root(base.replace_at(plan.root, p, new))


@register_rule
class FilterPushdown(Rule):
    """R1-2: push a filter below a join/crossJoin side it only references."""
    name = "R1-2"
    category = "O1"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if not isinstance(n, ir.Filter):
                continue
            if isinstance(n.child, (ir.Join, ir.CrossJoin)):
                ls, rs = _side_schemas(n.child, plan.registry, catalog)
                ap, bp = _prefixes(n.child)
                cols = n.pred.cols()
                if all(c.startswith(ap) and c[len(ap):] in ls for c in cols):
                    out.append(RuleConfig.make(self.name, path=p, side=0))
                if all(c.startswith(bp) and c[len(bp):] in rs for c in cols):
                    out.append(RuleConfig.make(self.name, path=p, side=1))
            elif isinstance(n.child, ir.Project):
                # commute below a project whose outputs the pred ignores —
                # the filter then runs before the (usually expensive) project
                made = {nm for nm, _ in n.child.outputs}
                if not (n.pred.cols() & made):
                    out.append(RuleConfig.make(self.name, path=p, side=-1))
        return out

    def apply(self, plan, catalog, cfg):
        p, side = cfg.get("path"), cfg.get("side")
        f = base.node_at(plan.root, p)
        if side == -1:  # Filter(Project(c)) -> Project(Filter(c))
            proj = f.child
            new = proj.with_children(
                (ir.Filter(proj.child, f.pred, selectivity=f.selectivity),))
            return plan.replace_root(base.replace_at(plan.root, p, new))
        join = f.child
        ap, bp = _prefixes(join)
        prefix = ap if side == 0 else bp
        pred = _strip_prefix(f.pred, prefix)
        kids = list(join.children())
        kids[side] = ir.Filter(kids[side], pred, selectivity=f.selectivity)
        return plan.replace_root(base.replace_at(plan.root, p, join.with_children(kids)))


@register_rule
class ProjectPushdown(Rule):
    """R1-3: push one project output below the join side it references."""
    name = "R1-3"
    category = "O1"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if not isinstance(n, ir.Project):
                continue
            if isinstance(n.child, (ir.Filter, ir.Compact)):
                # commute one output through the filter/compact so it can
                # keep sinking toward the join (Fig. 4-3's multi-step push)
                mid_schema = ir.infer(n.child, plan.registry, catalog).schema
                for name, e in n.outputs:
                    if e.cols() and name not in mid_schema:
                        out.append(RuleConfig.make(self.name, path=p,
                                                   output=name, side=-1))
                continue
            if not isinstance(n.child, (ir.Join, ir.CrossJoin)):
                continue
            ls, rs = _side_schemas(n.child, plan.registry, catalog)
            ap, bp = _prefixes(n.child)
            join_keys = set()
            if isinstance(n.child, ir.Join):
                join_keys = {n.child.left_key}
            for name, e in n.outputs:
                cols = e.cols()
                if name in join_keys or not cols:
                    continue
                # (prefixed sides would need a rename through the join; our
                # workloads use unique column names + empty prefixes)
                if ap == "" and name not in rs and all(c in ls for c in cols):
                    out.append(RuleConfig.make(self.name, path=p, output=name, side=0))
                if bp == "" and name not in ls and all(c in rs for c in cols):
                    out.append(RuleConfig.make(self.name, path=p, output=name, side=1))
        return out

    def apply(self, plan, catalog, cfg):
        p, name, side = cfg.get("path"), cfg.get("output"), cfg.get("side")
        proj = base.node_at(plan.root, p)
        if side == -1:  # commute through Filter/Compact
            mid = proj.child
            e = dict(proj.outputs)[name]
            below = ir.Project(mid.child, outputs=((name, e),), keep=None)
            new_mid = mid.with_children((below,))
            rest = tuple((n2, e2) for n2, e2 in proj.outputs if n2 != name)
            keep = proj.keep
            if keep is not None:
                keep = tuple(keep) + ((name,) if name not in keep else ())
            if rest or keep is not None:
                top: ir.RelNode = ir.Project(new_mid, outputs=rest, keep=keep)
            else:
                top = new_mid
            return plan.replace_root(base.replace_at(plan.root, p, top))
        join = proj.child
        e = dict(proj.outputs)[name]
        pushed = ir.Project(join.children()[side], outputs=((name, e),), keep=None)
        kids = list(join.children())
        kids[side] = pushed
        new_join = join.with_children(kids)
        rest = tuple((n2, e2) for n2, e2 in proj.outputs if n2 != name)
        keep = proj.keep
        if keep is not None:
            keep = tuple(keep) + ((name,) if name not in keep else ())
        if rest or keep is not None:
            top: ir.RelNode = ir.Project(new_join, outputs=rest, keep=keep)
        else:
            top = new_join
        return plan.replace_root(base.replace_at(plan.root, p, top))


@register_rule
class FilterMerge(Rule):
    """R1-4a: merge two adjacent filters into one AND-ed filter."""
    name = "R1-4-merge"
    category = "O1"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if isinstance(n, ir.Filter) and isinstance(n.child, ir.Filter):
                out.append(RuleConfig.make(self.name, path=p, kind="filter"))
            if (isinstance(n, ir.Project) and isinstance(n.child, ir.Project)
                    and n.keep is None and n.child.keep is None):
                inner_names = {nm for nm, _ in n.child.outputs}
                # only merge if outer exprs reference inner outputs at most once
                out.append(RuleConfig.make(self.name, path=p, kind="project"))
        return out

    def apply(self, plan, catalog, cfg):
        p = cfg.get("path")
        n = base.node_at(plan.root, p)
        if cfg.get("kind") == "filter":
            sel = None
            if n.selectivity is not None and n.child.selectivity is not None:
                sel = n.selectivity * n.child.selectivity
            new = ir.Filter(n.child.child,
                            ir.BoolOp("and", (n.child.pred, n.pred)),
                            selectivity=sel)
        else:
            inner = n.child
            mapping = {nm: e for nm, e in inner.outputs}
            outs = tuple((nm, base.subst_cols(e, mapping)) for nm, e in n.outputs)
            # inner outputs not overwritten by outer survive
            carried = tuple((nm, e) for nm, e in inner.outputs
                            if nm not in dict(outs))
            new = ir.Project(inner.child, outputs=carried + outs, keep=None)
        return plan.replace_root(base.replace_at(plan.root, p, new))


@register_rule
class FilterSplit(Rule):
    """R1-4b: split an AND filter / multi-output project (inverse of merge)."""
    name = "R1-4-split"
    category = "O1"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if (isinstance(n, ir.Filter) and isinstance(n.pred, ir.BoolOp)
                    and n.pred.op == "and" and len(n.pred.args) >= 2):
                out.append(RuleConfig.make(self.name, path=p, kind="filter"))
            if isinstance(n, ir.Project) and len(n.outputs) >= 2 and n.keep is None:
                names = [nm for nm, _ in n.outputs]
                used = set()
                for _, e in n.outputs:
                    used |= e.cols()
                for nm in names:
                    if nm not in used:  # output independent of siblings
                        out.append(RuleConfig.make(self.name, path=p, kind="project",
                                                   output=nm))
        return out

    def apply(self, plan, catalog, cfg):
        p = cfg.get("path")
        n = base.node_at(plan.root, p)
        if cfg.get("kind") == "filter":
            first, rest = n.pred.args[0], n.pred.args[1:]
            inner = ir.Filter(n.child, first)
            outer_pred = rest[0] if len(rest) == 1 else ir.BoolOp("and", rest)
            new = ir.Filter(inner, outer_pred)
        else:
            nm = cfg.get("output")
            e = dict(n.outputs)[nm]
            rest = tuple((a, b) for a, b in n.outputs if a != nm)
            new = ir.Project(ir.Project(n.child, outputs=rest, keep=None),
                             outputs=((nm, e),), keep=None)
        return plan.replace_root(base.replace_at(plan.root, p, new))


@register_rule
class CompactAfterFilter(Rule):
    """Physical enabler of R1-2/R1-3's payoff: shrink the static capacity
    after a selective filter.

    Static shapes make the capacity a *correctness* bound, so compaction
    uses exact live-row counts: cheap predicate evaluation on the numpy
    base tables where possible, otherwise a count of the filter subtree run
    through ``executor.execute`` on the device the catalog's tables live on
    (cached on the catalog). A wrong estimate here would drop rows rather
    than merely slow the query, so no estimate is ever accepted."""
    name = "compact"
    category = "O1"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if not isinstance(n, ir.Filter) or isinstance(n.child, ir.Compact):
                continue
            # don't stack compacts
            parent = base.node_at(plan.root, p[:-1]) if p else None
            if isinstance(parent, ir.Compact):
                continue
            bound = self._row_bound(n, plan, catalog)
            if bound is None:
                continue
            ci = ir.infer(n.child, plan.registry, catalog)
            cap = _round_up(bound)
            if cap < ci.capacity * 0.75:
                out.append(RuleConfig.make(self.name, path=p, capacity=cap))
        return out

    def _row_bound(self, f: ir.Filter, plan, catalog):
        if isinstance(f.child, ir.Scan) and not evaluator.has_call(f.pred):
            npt = catalog.np_tables[f.child.table]
            if npt:
                mask = evaluator.eval_expr(f.pred, npt, plan.registry, xp=np)
                return int(np.sum(mask))
        # cached on the catalog, so it dies with it (an id(catalog) key
        # could serve a freed catalog's count to a new one with its id)
        cache = catalog.__dict__.setdefault("_compact_rule_counts", {})
        key = ir.plan_signature(f)
        if key in cache:
            return cache[key]
        ci = ir.infer(f.child, plan.registry, catalog)
        if ci.capacity > 2_000_000:  # too big to count eagerly
            return None
        from repro_torch.core import cost, executor
        try:
            t = executor.execute(ir.Plan(f, plan.registry, plan.phys), catalog,
                                 device=cost.catalog_device(catalog))
            bound = int(t.num_valid())
        except (ValueError, NotImplementedError, torch.cuda.OutOfMemoryError):
            # operands a kernel or operator refuses, a realization the port
            # does not have, or a subtree too large for the device: no
            # bound, as for a subtree over the size cap. Anything else (a
            # CUDA error, a kernel that does not build) raises.
            bound = None
        cache[key] = bound
        return bound

    def apply(self, plan, catalog, cfg):
        p = cfg.get("path")
        n = base.node_at(plan.root, p)
        new = ir.Compact(n, capacity=cfg.get("capacity"))
        return plan.replace_root(base.replace_at(plan.root, p, new))


def _round_up(n: int) -> int:
    n = max(int(n), 8)
    p = 8
    while p < n:
        p *= 2
    return p
