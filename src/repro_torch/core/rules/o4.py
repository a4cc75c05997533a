"""O4 — data-model cross optimization.

R4-1-split : cut a single-input-subset subgraph out of a high-level ML
             function and materialize it as its own Project column (paper
             Fig. 4-1/4-2 — splitting twoTowerModel into towers + cosSim).
R4-1-fuse  : fuse matMul->bias->act chains into a fused_dense operator.
R4-1-unfuse: the inverse split of fused_dense.
R4-2       : physical backend replacement (torch <-> hand-written kernels;
             the paper's CPU/GPU/sparse library choice).
R4-4       : constant folding inside expressions.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core import ir
from repro_torch.core.rules import base
from repro_torch.core.rules.base import Rule, RuleConfig, register_rule, fresh_col
from repro_torch.mlfuncs.functions import Atom, MLFunction, MLGraph, MLNode

_MERGE_KINDS = ("concat", "cossim", "dot", "dist", "add", "mul")


@register_rule
class SplitDisjoint(Rule):
    name = "R4-1-split"
    category = "O4"

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
                if fn.graph is None or fn.n_inputs < 2:
                    continue
                deps = fn.graph.input_deps()
                all_in = frozenset(range(fn.n_inputs))
                for gn in fn.graph.nodes:
                    if gn.id == fn.graph.out:
                        continue
                    # cut at args of merge nodes whose subgraph uses a proper
                    # subset of inputs and does real work
                    if deps[gn.id] and deps[gn.id] != all_in and len(
                            base.ancestors(fn.graph, gn.id)) >= 2:
                        users = base.graph_users(fn.graph)[gn.id]
                        by_id = {x.id: x for x in fn.graph.nodes}
                        if any(by_id[u].atom.kind in _MERGE_KINDS for u in users):
                            out.append(RuleConfig.make(self.name, path=p,
                                                       output=name, fn=e.fn,
                                                       node=gn.id))
        return out

    def apply(self, plan, catalog, cfg):
        registry = plan.registry.copy()
        fn = registry.get(cfg.get("fn"))
        g = fn.graph
        cut = cfg.get("node")
        sub, in_order = base.extract_subgraph(g, cut)
        res = base.residual_graph(g, cut, new_input=g.n_inputs)
        # prune inputs the residual no longer touches (their argument
        # expressions — possibly expensive nested calls — must not be
        # evaluated at this level anymore)
        used = sorted({r[1] for n in res.nodes for r in n.args if r[0] == "in"})
        remap = {old: new for new, old in enumerate(used)}
        res_nodes = [
            type(n)(id=n.id, atom=n.atom,
                    args=tuple(("in", remap[r[1]]) if r[0] == "in" else r
                               for r in n.args))
            for n in res.nodes]
        res = type(res)(nodes=res_nodes, out=res.out, n_inputs=len(used))
        sub_name = registry.fresh_name(fn.name + "_sub")
        res_name = registry.fresh_name(fn.name + "_res")
        registry.replace(MLFunction(name=sub_name, graph=sub, n_inputs=sub.n_inputs))
        registry.replace(MLFunction(name=res_name, graph=res, n_inputs=res.n_inputs))
        proj = base.node_at(plan.root, cfg.get("path"))
        call = dict(proj.outputs)[cfg.get("output")]
        tmp = fresh_col("split")
        sub_call = ir.Call(sub_name, tuple(call.args[i] for i in in_order))
        below = ir.Project(proj.child, outputs=((tmp, sub_call),), keep=None)
        ext_args = tuple(call.args) + (ir.Col(tmp),)
        res_call = ir.Call(res_name, tuple(ext_args[i] for i in used))
        outs = tuple((n2, res_call if n2 == cfg.get("output") else e2)
                     for n2, e2 in proj.outputs)
        keep = proj.keep
        if keep is None:
            # drop the tmp column so the output schema is unchanged
            child_schema = ir.infer(proj.child, plan.registry, catalog).schema
            keep = tuple(sorted(child_schema))
        new_proj = ir.Project(below, outputs=outs, keep=keep)
        root = base.replace_at(plan.root, cfg.get("path"), new_proj)
        return ir.Plan(root, registry, plan.phys)


@register_rule
class FuseDense(Rule):
    name = "R4-1-fuse"
    category = "O4"

    def configs(self, plan, catalog):
        out = []
        seen = set()
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if not isinstance(n, ir.Project):
                continue
            for name, e in n.outputs:
                for call in base.expr_calls(e):
                    fn = plan.registry.get(call.fn)
                    if fn.graph is None:
                        continue
                    for trip in _fusable_triples(fn.graph):
                        key = (call.fn, trip)
                        if key in seen:
                            continue
                        seen.add(key)
                        out.append(RuleConfig.make(self.name, path=p, output=name,
                                                   fn=call.fn, matmul=trip))
        return out

    def apply(self, plan, catalog, cfg):
        registry = plan.registry.copy()
        fn = registry.get(cfg.get("fn"))
        g = fn.graph
        mm_id = cfg.get("matmul")
        mm = g.node(mm_id)
        users = base.graph_users(g)
        bias = g.node(users[mm_id][0])
        act = g.node(users[bias.id][0])
        fused = Atom("fused_dense", {"w": mm.atom.params["w"],
                                     "b": bias.atom.params["b"],
                                     "act": act.atom.params["fn"]})
        nid = g.fresh_id()
        new_node = MLNode(id=nid, atom=fused, args=mm.args)
        # remove mm/bias, rewire act's node id to fused output
        nodes = []
        for n in g.nodes:
            if n.id in (mm_id, bias.id):
                continue
            if n.id == act.id:
                nodes.append(MLNode(id=act.id, atom=Atom("act", {"fn": "identity"}),
                                    args=(("node", nid),)))
                nodes.insert(len(nodes) - 1, new_node)
                continue
            nodes.append(n)
        g2 = MLGraph(nodes=nodes, out=g.out, n_inputs=g.n_inputs)
        new_name = registry.fresh_name(fn.name + "_fused")
        registry.replace(dataclasses.replace(fn, name=new_name, graph=g2))
        root = _rename_call(plan.root, cfg.get("path"), cfg.get("fn"), new_name)
        return ir.Plan(root, registry, plan.phys)


@register_rule
class UnfuseDense(Rule):
    name = "R4-1-unfuse"
    category = "O4"

    def configs(self, plan, catalog):
        out = []
        seen = set()
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if not isinstance(n, ir.Project):
                continue
            for name, e in n.outputs:
                for call in base.expr_calls(e):
                    fn = plan.registry.get(call.fn)
                    if fn.graph is None:
                        continue
                    for gn in fn.graph.nodes:
                        if gn.atom.kind == "fused_dense" and (call.fn, gn.id) not in seen:
                            seen.add((call.fn, gn.id))
                            out.append(RuleConfig.make(self.name, path=p,
                                                       fn=call.fn, node=gn.id))
        return out

    def apply(self, plan, catalog, cfg):
        registry = plan.registry.copy()
        fn = registry.get(cfg.get("fn"))
        g = fn.graph
        fd = g.node(cfg.get("node"))
        nid = g.fresh_id()
        mm = MLNode(id=nid, atom=Atom("matmul", {"w": fd.atom.params["w"]}), args=fd.args)
        bi = MLNode(id=nid + 1, atom=Atom("bias", {"b": fd.atom.params["b"]}),
                    args=(("node", nid),))
        ac = MLNode(id=nid + 2, atom=Atom("act", {"fn": fd.atom.params["act"]}),
                    args=(("node", nid + 1),))
        g2 = base.replace_graph_node(g, fd.id, [mm, bi, ac], nid + 2)
        new_name = registry.fresh_name(fn.name + "_unfused")
        registry.replace(dataclasses.replace(fn, name=new_name, graph=g2))
        root = _rename_call(plan.root, cfg.get("path"), cfg.get("fn"), new_name)
        return ir.Plan(root, registry, plan.phys)


@register_rule
class BackendReplace(Rule):
    name = "R4-2"
    category = "O4"

    def configs(self, plan, catalog):
        out = []
        seen = set()
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            if isinstance(n, (ir.BlockedMatmul, ir.ForestRelational)):
                pc = plan.phys_for(n)
                for be in ("torch", "kernel"):
                    if be != pc.backend:
                        out.append(RuleConfig.make(self.name, path=p, kind="node",
                                                   backend=be))
                if pc.mode == "relational":
                    out.append(RuleConfig.make(self.name, path=p, kind="mode",
                                               backend="fused"))
            if isinstance(n, ir.Project):
                for name, e in n.outputs:
                    for call in base.expr_calls(e):
                        fn = plan.registry.get(call.fn)
                        if fn.graph is None:
                            continue
                        for gn in fn.graph.nodes:
                            if gn.atom.kind in ("fused_dense", "forest"):
                                be = "kernel" if gn.atom.backend == "torch" else "torch"
                                key = (call.fn, gn.id, be)
                                if key in seen:
                                    continue
                                seen.add(key)
                                out.append(RuleConfig.make(self.name, path=p,
                                                           kind="atom", fn=call.fn,
                                                           node=gn.id, backend=be))
        return out

    def apply(self, plan, catalog, cfg):
        if cfg.get("kind") == "node":
            n = base.node_at(plan.root, cfg.get("path"))
            new_cfg = dataclasses.replace(plan.phys_for(n),
                                          backend=cfg.get("backend"))
            return plan.with_phys(n.uid, new_cfg)
        if cfg.get("kind") == "mode":
            n = base.node_at(plan.root, cfg.get("path"))
            new_cfg = dataclasses.replace(plan.phys_for(n), mode="fused")
            return plan.with_phys(n.uid, new_cfg)
        registry = plan.registry.copy()
        fn = registry.get(cfg.get("fn"))
        g = fn.graph
        nodes = []
        for n in g.nodes:
            if n.id == cfg.get("node"):
                atom = dataclasses.replace(n.atom, backend=cfg.get("backend"))
                nodes.append(MLNode(id=n.id, atom=atom, args=n.args))
            else:
                nodes.append(n)
        g2 = MLGraph(nodes=nodes, out=g.out, n_inputs=g.n_inputs)
        new_name = registry.fresh_name(fn.name + "_be")
        registry.replace(dataclasses.replace(fn, name=new_name, graph=g2))
        root = _rename_call(plan.root, cfg.get("path"), cfg.get("fn"), new_name)
        return ir.Plan(root, registry, plan.phys)


@register_rule
class ConstantFold(Rule):
    name = "R4-4"
    category = "O4"

    def configs(self, plan, catalog):
        out = []
        for p in base.all_paths(plan.root):
            n = base.node_at(plan.root, p)
            exprs = []
            if isinstance(n, ir.Filter):
                exprs = [n.pred]
            elif isinstance(n, ir.Project):
                exprs = [e for _, e in n.outputs]
            if any(_foldable(e) for e in exprs):
                out.append(RuleConfig.make(self.name, path=p))
        return out

    def apply(self, plan, catalog, cfg):
        n = base.node_at(plan.root, cfg.get("path"))
        if isinstance(n, ir.Filter):
            new = dataclasses.replace(n, pred=_fold(n.pred))
        else:
            new = dataclasses.replace(
                n, outputs=tuple((nm, _fold(e)) for nm, e in n.outputs))
        return plan.replace_root(base.replace_at(plan.root, cfg.get("path"), new))


def _fusable_triples(g: MLGraph):
    users = base.graph_users(g)
    by_id = {n.id: n for n in g.nodes}
    for n in g.nodes:
        if n.atom.kind != "matmul":
            continue
        if len(users[n.id]) != 1:
            continue
        b = by_id[users[n.id][0]]
        if b.atom.kind != "bias" or len(users[b.id]) != 1:
            continue
        a = by_id[users[b.id][0]]
        if a.atom.kind != "act":
            continue
        yield n.id


def _rename_call(root, path, old_fn, new_fn):
    node = base.node_at(root, path)

    def rn(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.Call):
            args = tuple(rn(a) for a in e.args)
            return ir.Call(new_fn if e.fn == old_fn else e.fn, args)
        if isinstance(e, ir.BinOp):
            return ir.BinOp(e.op, rn(e.a), rn(e.b))
        if isinstance(e, ir.Cmp):
            return ir.Cmp(e.op, rn(e.a), rn(e.b))
        if isinstance(e, ir.BoolOp):
            return ir.BoolOp(e.op, tuple(rn(a) for a in e.args))
        if isinstance(e, ir.IsIn):
            return ir.IsIn(rn(e.a), e.values)
        if isinstance(e, ir.IfExpr):
            return ir.IfExpr(rn(e.cond), rn(e.t), rn(e.f))
        return e

    if isinstance(node, ir.Project):
        new = dataclasses.replace(
            node, outputs=tuple((nm, rn(e)) for nm, e in node.outputs))
    elif isinstance(node, ir.Filter):
        new = dataclasses.replace(node, pred=rn(node.pred))
    else:
        raise TypeError(type(node))
    return base.replace_at(root, path, new)


def _foldable(e: ir.Expr) -> bool:
    if isinstance(e, (ir.BinOp, ir.Cmp)) and isinstance(e.a, ir.Const) \
            and isinstance(e.b, ir.Const):
        return True
    return any(_foldable(c) for c in e.children())


def _fold(e: ir.Expr) -> ir.Expr:
    if isinstance(e, ir.BinOp):
        a, b = _fold(e.a), _fold(e.b)
        if isinstance(a, ir.Const) and isinstance(b, ir.Const):
            va, vb = a.value, b.value
            return ir.Const({"+": va + vb, "-": va - vb, "*": va * vb,
                             "/": va / (vb if vb else 1e-9)}[e.op])
        return ir.BinOp(e.op, a, b)
    if isinstance(e, ir.Cmp):
        a, b = _fold(e.a), _fold(e.b)
        if isinstance(a, ir.Const) and isinstance(b, ir.Const):
            va, vb = a.value, b.value
            return ir.Const(float({"<": va < vb, ">": va > vb, "<=": va <= vb,
                                   ">=": va >= vb, "==": va == vb,
                                   "!=": va != vb}[e.op]))
        return ir.Cmp(e.op, a, b)
    if isinstance(e, ir.BoolOp):
        return ir.BoolOp(e.op, tuple(_fold(a) for a in e.args))
    if isinstance(e, ir.IsIn):
        return ir.IsIn(_fold(e.a), e.values)
    if isinstance(e, ir.IfExpr):
        return ir.IfExpr(_fold(e.cond), _fold(e.t), _fold(e.f))
    if isinstance(e, ir.Call):
        return ir.Call(e.fn, tuple(_fold(a) for a in e.args))
    return e
