"""O3 — tensor-relational transformation (TRA lineage).

R3-1: a large matMul inside a chain-shaped ML function becomes a
      BlockedMatmul relational pipeline over a weight-tile relation
      (paper Fig. 2). Default mode is the literal 'relational' realization;
      R4-2 may replace it with the pipelined 'fused' physical form.
R3-2: decision forest -> crossJoin(T, DF) + project + aggregate
      (ForestRelational node).
R3-3: distances-to-centroids -> centroid-relation form, expressed by
      expanding the opaque kmeans function into matMul+bias+argmin atoms
      (which makes it eligible for R3-1/R2-1 downstream — the composition
      story of Sec. II-A's closing example).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core import ir
from repro_torch.core.rules import base
from repro_torch.core.rules.base import Rule, RuleConfig, register_rule, fresh_col
from repro_torch.mlfuncs.functions import Atom, MLFunction, MLGraph, MLNode


MIN_TENSOR_BYTES = 16 * 1024  # only worth transforming sizeable weights


def _chain_split(g: MLGraph, idx: int):
    """Split a chain graph around node index idx -> (pre, node, post)."""
    nodes = g.nodes
    pre = nodes[:idx]
    post = nodes[idx + 1:]

    def as_chain(ns):
        if not ns:
            return None
        out_nodes, prev = [], ("in", 0)
        for i, n in enumerate(ns):
            out_nodes.append(MLNode(id=i, atom=n.atom, args=(prev,)))
            prev = ("node", i)
        return MLGraph(nodes=out_nodes, out=len(ns) - 1, n_inputs=1)

    return as_chain(pre), nodes[idx], as_chain(post)


@register_rule
class TensorRelationalMatmul(Rule):
    name = "R3-1"
    category = "O3"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if not isinstance(n, ir.Project):
                continue
            for name, e in n.outputs:
                if not isinstance(e, ir.Call) or len(e.args) != 1:
                    continue
                fn = plan.registry.get(e.fn)
                if fn.graph is None or not base.is_chain(fn.graph):
                    continue
                for i, gn in enumerate(fn.graph.nodes):
                    if gn.atom.kind == "matmul" and gn.atom.param_bytes() >= MIN_TENSOR_BYTES:
                        out.append(RuleConfig.make(self.name, path=p, output=name,
                                                   fn=e.fn, idx=i))
        return out

    def apply(self, plan, catalog, cfg):
        registry = plan.registry.copy()
        fn = registry.get(cfg.get("fn"))
        pre, mm_node, post = _chain_split(fn.graph, cfg.get("idx"))
        w = np.asarray(mm_node.atom.params["w"])
        mm_name = registry.fresh_name(fn.name + "_mm")
        registry.replace(MLFunction(
            name=mm_name,
            graph=MLGraph([MLNode(0, Atom("matmul", {"w": w}), (("in", 0),))], 0, 1),
            n_inputs=1))
        proj = base.node_at(plan.root, cfg.get("path"))
        call = dict(proj.outputs)[cfg.get("output")]
        arg = call.args[0]
        child = proj.child
        child_schema = tuple(sorted(ir.infer(child, registry, catalog).schema))
        # stage 1: pre-chain (or raw column)
        if pre is None and isinstance(arg, ir.Col):
            x_col = arg.name
            stage = child
        else:
            x_col = fresh_col("x")
            if pre is None:
                stage_expr = arg
            else:
                pre_name = registry.fresh_name(fn.name + "_pre")
                registry.replace(MLFunction(name=pre_name, graph=pre, n_inputs=1))
                stage_expr = ir.Call(pre_name, (arg,))
            stage = ir.Project(child, outputs=((x_col, stage_expr),), keep=None)
        # stage 2: the tensor-relational matmul (physical realization is a
        # side-table annotation, not a logical-node field)
        y_col = fresh_col("y")
        bm = ir.BlockedMatmul(stage, x_col=x_col, out_col=y_col, fn=mm_name)
        phys = {**plan.phys,
                bm.uid: ir.PhysConfig(mode="relational", backend="torch",
                                      n_tiles=ir.default_n_tiles(registry,
                                                                 mm_name))}
        # stage 3: post-chain + the rest of the original outputs
        if post is None:
            final_expr: ir.Expr = ir.Col(y_col)
        else:
            post_name = registry.fresh_name(fn.name + "_post")
            registry.replace(MLFunction(name=post_name, graph=post, n_inputs=1))
            final_expr = ir.Call(post_name, (ir.Col(y_col),))
        rest = tuple((n2, e2) for n2, e2 in proj.outputs if n2 != cfg.get("output"))
        keep = proj.keep if proj.keep is not None else child_schema
        top = ir.Project(bm, outputs=rest + ((cfg.get("output"), final_expr),),
                         keep=keep)
        root = base.replace_at(plan.root, cfg.get("path"), top)
        return ir.Plan(root, registry, phys)


@register_rule
class ForestToRelational(Rule):
    name = "R3-2"
    category = "O3"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if not isinstance(n, ir.Project):
                continue
            for name, e in n.outputs:
                if not (isinstance(e, ir.Call) and len(e.args) == 1
                        and isinstance(e.args[0], ir.Col)):
                    continue
                fn = plan.registry.get(e.fn)
                if (fn.graph is not None and len(fn.graph.nodes) == 1
                        and fn.graph.nodes[0].atom.kind == "forest"):
                    out.append(RuleConfig.make(self.name, path=p, output=name,
                                               fn=e.fn))
        return out

    def apply(self, plan, catalog, cfg):
        proj = base.node_at(plan.root, cfg.get("path"))
        call = dict(proj.outputs)[cfg.get("output")]
        child_schema = tuple(sorted(ir.infer(proj.child, plan.registry, catalog).schema))
        fr = ir.ForestRelational(proj.child, x_col=call.args[0].name,
                                 out_col=cfg.get("output"), fn=cfg.get("fn"))
        phys = {**plan.phys,
                fr.uid: ir.PhysConfig(mode="relational", backend="torch")}
        rest = tuple((n2, e2) for n2, e2 in proj.outputs if n2 != cfg.get("output"))
        keep = proj.keep if proj.keep is not None else child_schema
        if rest or proj.keep is not None:
            keep2 = tuple(keep) + ((cfg.get("output"),)
                                   if cfg.get("output") not in keep else ())
            top: ir.RelNode = ir.Project(fr, outputs=rest, keep=keep2)
        else:
            top = fr
        root = base.replace_at(plan.root, cfg.get("path"), top)
        return ir.Plan(root, plan.registry, phys)


@register_rule
class CentroidsToRelational(Rule):
    name = "R3-3"
    category = "O3"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if not isinstance(n, ir.Project):
                continue
            for name, e in n.outputs:
                if not isinstance(e, ir.Call):
                    continue
                fn = plan.registry.get(e.fn)
                if fn.graph is None and hasattr(fn, "centroids"):
                    out.append(RuleConfig.make(self.name, path=p, output=name,
                                               fn=e.fn))
        return out

    def apply(self, plan, catalog, cfg):
        registry = plan.registry.copy()
        fn = registry.get(cfg.get("fn"))
        c = np.asarray(fn.centroids)  # type: ignore[attr-defined]
        w = (-2.0 * c.T).astype(np.float32)            # [d, k]
        b = np.sum(c * c, axis=1).astype(np.float32)   # [k]
        g = MLGraph(nodes=[
            MLNode(0, Atom("matmul", {"w": w}), (("in", 0),)),
            MLNode(1, Atom("bias", {"b": b}), (("node", 0),)),
            MLNode(2, Atom("argmin"), (("node", 1),)),
        ], out=2, n_inputs=1)
        new_name = registry.fresh_name(fn.name + "_rel")
        registry.replace(MLFunction(name=new_name, graph=g, n_inputs=1))
        proj = base.node_at(plan.root, cfg.get("path"))
        call = dict(proj.outputs)[cfg.get("output")]
        outs = tuple((n2, ir.Call(new_name, call.args) if n2 == cfg.get("output") else e2)
                     for n2, e2 in proj.outputs)
        root = base.replace_at(plan.root, cfg.get("path"),
                               dataclasses.replace(proj, outputs=outs))
        return ir.Plan(root, registry, plan.phys)
