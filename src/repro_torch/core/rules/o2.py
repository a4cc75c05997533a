"""O2 — factorized inference (paper R2-1/R2-3, Morpheus/LMFAO lineage).

R2-1 rewrites matMul(concat(x_S, x_R), W) into
matMul(x_S, W_S) + matMul(x_R, W_R) inside the bottom-level IR. The partial
matmuls then become independent single-input subgraphs, which R4-1-split +
R1-3 push below the join — eliminating the redundant compute the join's
row replication would cause (paper Fig. 1 / Fig. 12(d)).

R2-3 factorizes Euclidean distance over concatenated features:
dist([a,b],[c,d]) = sqrt(dist(a,c)^2 + dist(b,d)^2).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core import ir
from repro_torch.core.rules import base
from repro_torch.core.rules.base import Rule, RuleConfig, register_rule
from repro_torch.mlfuncs.functions import Atom, MLFunction, MLGraph, MLNode


def _project_calls(plan, catalog):
    """Yield (path, out_name, call_expr, child_schema) for Project outputs
    that are direct Calls."""
    for p in base.all_paths(plan.root):
        n = base.node_at(plan.root, p)
        if not isinstance(n, ir.Project):
            continue
        ci = ir.infer(n.child, plan.registry, catalog)
        for name, e in n.outputs:
            if isinstance(e, ir.Call):
                yield p, name, e, ci.schema


def _concat_matmul_nodes(g: MLGraph):
    """Yield (concat_node, matmul_node) pairs where matmul consumes a concat
    of graph inputs."""
    by_id = {n.id: n for n in g.nodes}
    for n in g.nodes:
        if n.atom.kind != "matmul" or len(n.args) != 1:
            continue
        r = n.args[0]
        if r[0] != "node":
            continue
        c = by_id[r[1]]
        if c.atom.kind != "concat":
            continue
        if all(a[0] == "in" for a in c.args):
            yield c, n


@register_rule
class FactorizeLinear(Rule):
    name = "R2-1"
    category = "O2"

    def configs(self, plan, catalog):
        out = []
        for p, name, call, schema in _project_calls(plan, catalog):
            fn = plan.registry.get(call.fn)
            if fn.graph is None or fn.n_inputs < 2:
                continue
            for c, m in _concat_matmul_nodes(fn.graph):
                out.append(RuleConfig.make(self.name, path=p, output=name,
                                           fn=call.fn, matmul=m.id))
        return out

    def apply(self, plan, catalog, cfg):
        registry = plan.registry.copy()
        fn = registry.get(cfg.get("fn"))
        g = fn.graph
        m = g.node(cfg.get("matmul"))
        c = g.node(m.args[0][1])
        w = np.asarray(m.atom.params["w"])
        # find the Call site to learn input dims
        proj = base.node_at(plan.root, cfg.get("path"))
        call = dict(proj.outputs)[cfg.get("output")]
        schema = ir.infer(proj.child, registry, catalog).schema
        in_dims = [max(ir.expr_dim(a, schema, registry), 1) for a in call.args]
        # split W rows by concat argument spans
        spans = []
        off = 0
        for r in c.args:
            d = in_dims[r[1]]
            spans.append((r[1], off, off + d))
            off += d
        assert off == w.shape[0], f"weight rows {w.shape[0]} != concat dim {off}"
        nid = g.fresh_id()
        new_nodes: List[MLNode] = []
        partial_refs = []
        for in_idx, lo, hi in spans:
            atom = Atom("matmul", {"w": w[lo:hi].copy()})
            new_nodes.append(MLNode(id=nid, atom=atom, args=(("in", in_idx),)))
            partial_refs.append(("node", nid))
            nid += 1
        # chain of adds
        acc = partial_refs[0]
        for ref in partial_refs[1:]:
            new_nodes.append(MLNode(id=nid, atom=Atom("add"), args=(acc, ref)))
            acc = ("node", nid)
            nid += 1
        g2 = base.replace_graph_node(g, m.id, new_nodes, acc[1])
        # drop the concat node if now unused
        g2 = _prune_unused(g2)
        new_name = registry.fresh_name(fn.name + "_fact")
        registry.replace(dataclasses.replace(fn, name=new_name, graph=g2))
        new_call = ir.Call(new_name, call.args)
        outs = tuple((n2, new_call if n2 == cfg.get("output") else e2)
                     for n2, e2 in proj.outputs)
        new_proj = dataclasses.replace(proj, outputs=outs)
        root = base.replace_at(plan.root, cfg.get("path"), new_proj)
        return ir.Plan(root, registry, plan.phys)


@register_rule
class FactorizeDistance(Rule):
    """R2-3: dist(concat(a,b), concat(c,d)) -> sqrt(d(a,c)^2 + d(b,d)^2)."""
    name = "R2-3"
    category = "O2"

    def configs(self, plan, catalog):
        out = []
        for p, name, call, schema in _project_calls(plan, catalog):
            fn = plan.registry.get(call.fn)
            if fn.graph is None:
                continue
            by_id = {n.id: n for n in fn.graph.nodes}
            for n in fn.graph.nodes:
                if n.atom.kind != "dist" or len(n.args) != 2:
                    continue
                if not all(r[0] == "node" and by_id[r[1]].atom.kind == "concat"
                           for r in n.args):
                    continue
                ca, cb = by_id[n.args[0][1]], by_id[n.args[1][1]]
                if len(ca.args) == len(cb.args) and all(
                        r[0] == "in" for r in ca.args + cb.args):
                    out.append(RuleConfig.make(self.name, path=p, output=name,
                                               fn=call.fn, dist=n.id))
        return out

    def apply(self, plan, catalog, cfg):
        registry = plan.registry.copy()
        fn = registry.get(cfg.get("fn"))
        g = fn.graph
        n = g.node(cfg.get("dist"))
        by_id = {x.id: x for x in g.nodes}
        ca, cb = by_id[n.args[0][1]], by_id[n.args[1][1]]
        new_nodes: List[MLNode] = []
        nid = g.fresh_id()
        sq_refs = []
        for ra, rb in zip(ca.args, cb.args):
            new_nodes.append(MLNode(id=nid, atom=Atom("dist"), args=(ra, rb)))
            dref = ("node", nid)
            nid += 1
            new_nodes.append(MLNode(id=nid, atom=Atom("mul"), args=(dref, dref)))
            sq_refs.append(("node", nid))
            nid += 1
        acc = sq_refs[0]
        for ref in sq_refs[1:]:
            new_nodes.append(MLNode(id=nid, atom=Atom("add"), args=(acc, ref)))
            acc = ("node", nid)
            nid += 1
        new_nodes.append(MLNode(id=nid, atom=Atom("sqrt"), args=(acc,)))
        g2 = base.replace_graph_node(g, n.id, new_nodes, nid)
        g2 = _prune_unused(g2)
        new_name = registry.fresh_name(fn.name + "_dfact")
        registry.replace(dataclasses.replace(fn, name=new_name, graph=g2))
        proj = base.node_at(plan.root, cfg.get("path"))
        call = dict(proj.outputs)[cfg.get("output")]
        outs = tuple((n2, ir.Call(new_name, call.args) if n2 == cfg.get("output") else e2)
                     for n2, e2 in proj.outputs)
        root = base.replace_at(plan.root, cfg.get("path"),
                               dataclasses.replace(proj, outputs=outs))
        return ir.Plan(root, registry, plan.phys)


def _prune_unused(g: MLGraph) -> MLGraph:
    needed = set()
    stack = [g.out]
    while stack:
        cur = stack.pop()
        if cur in needed:
            continue
        needed.add(cur)
        for r in g.node(cur).args:
            if r[0] == "node":
                stack.append(r[1])
    return MLGraph(nodes=[n for n in g.nodes if n.id in needed], out=g.out,
                   n_inputs=g.n_inputs)
