"""Rule framework: plan-path addressing, expression/graph surgery helpers."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import ir
from repro_torch.mlfuncs.functions import Atom, MLFunction, MLGraph, MLNode

Path = Tuple[int, ...]


# ---------------------------------------------------------------------------
# path addressing over the immutable plan tree
# ---------------------------------------------------------------------------

def node_at(root: ir.RelNode, path: Path) -> ir.RelNode:
    n = root
    for i in path:
        n = n.children()[i]
    return n


def replace_at(root: ir.RelNode, path: Path, new: ir.RelNode) -> ir.RelNode:
    if not path:
        return new
    kids = list(root.children())
    kids[path[0]] = replace_at(kids[path[0]], path[1:], new)
    return root.with_children(kids)


def all_paths(root: ir.RelNode, path: Path = ()) -> List[Path]:
    out = [path]
    for i, c in enumerate(root.children()):
        out.extend(all_paths(c, path + (i,)))
    return out


# ---------------------------------------------------------------------------
# expression surgery
# ---------------------------------------------------------------------------

def subst_cols(e: ir.Expr, mapping: Dict[str, ir.Expr]) -> ir.Expr:
    if isinstance(e, ir.Col):
        return mapping.get(e.name, e)
    if isinstance(e, ir.Const):
        return e
    if isinstance(e, ir.BinOp):
        return ir.BinOp(e.op, subst_cols(e.a, mapping), subst_cols(e.b, mapping))
    if isinstance(e, ir.Cmp):
        return ir.Cmp(e.op, subst_cols(e.a, mapping), subst_cols(e.b, mapping))
    if isinstance(e, ir.BoolOp):
        return ir.BoolOp(e.op, tuple(subst_cols(a, mapping) for a in e.args))
    if isinstance(e, ir.IsIn):
        return ir.IsIn(subst_cols(e.a, mapping), e.values)
    if isinstance(e, ir.IfExpr):
        return ir.IfExpr(subst_cols(e.cond, mapping), subst_cols(e.t, mapping),
                         subst_cols(e.f, mapping))
    if isinstance(e, ir.Call):
        return ir.Call(e.fn, tuple(subst_cols(a, mapping) for a in e.args))
    raise TypeError(type(e))


def expr_calls(e: ir.Expr):
    if isinstance(e, ir.Call):
        yield e
    for c in e.children():
        yield from expr_calls(c)


# ---------------------------------------------------------------------------
# ML graph surgery (bottom-level IR rewrites)
# ---------------------------------------------------------------------------

def graph_users(g: MLGraph) -> Dict[int, List[int]]:
    users: Dict[int, List[int]] = {n.id: [] for n in g.nodes}
    for n in g.nodes:
        for r in n.args:
            if r[0] == "node":
                users[r[1]].append(n.id)
    return users


def ancestors(g: MLGraph, nid: int) -> List[int]:
    """Transitive producers of node nid (including nid), topo order."""
    keep = set()
    stack = [nid]
    while stack:
        cur = stack.pop()
        if cur in keep:
            continue
        keep.add(cur)
        for r in g.node(cur).args:
            if r[0] == "node":
                stack.append(r[1])
    return [n.id for n in g.nodes if n.id in keep]


def extract_subgraph(g: MLGraph, nid: int) -> Tuple[MLGraph, List[int]]:
    """Subgraph computing node nid. Returns (sub, input_order) where
    input_order lists original graph-input indices in sub-input order."""
    ids = ancestors(g, nid)
    in_order: List[int] = []
    for i in ids:
        for r in g.node(i).args:
            if r[0] == "in" and r[1] not in in_order:
                in_order.append(r[1])
    remap_in = {orig: k for k, orig in enumerate(in_order)}
    nodes = []
    for i in ids:
        n = g.node(i)
        args = tuple(("in", remap_in[r[1]]) if r[0] == "in" else r for r in n.args)
        nodes.append(MLNode(id=n.id, atom=n.atom, args=args))
    return MLGraph(nodes=nodes, out=nid, n_inputs=len(in_order)), in_order


def residual_graph(g: MLGraph, cut: int, new_input: int) -> MLGraph:
    """Graph with node ``cut`` replaced by graph input ``new_input``.
    Nodes used only to compute ``cut`` are dropped."""
    sub_ids = set(ancestors(g, cut))
    # nodes needed by the output, treating `cut` as an input
    needed = set()
    stack = [g.out]
    while stack:
        cur = stack.pop()
        if cur in needed or cur == cut:
            continue
        needed.add(cur)
        for r in g.node(cur).args:
            if r[0] == "node" and r[1] != cut:
                stack.append(r[1])
    nodes = []
    for n in g.nodes:
        if n.id not in needed:
            continue
        args = tuple(("in", new_input) if (r == ("node", cut)) else r for r in n.args)
        nodes.append(MLNode(id=n.id, atom=n.atom, args=args))
    assert g.out != cut, "cannot cut the output node"
    return MLGraph(nodes=nodes, out=g.out, n_inputs=new_input + 1)


def replace_graph_node(g: MLGraph, nid: int, new_nodes: List[MLNode],
                       new_out: int) -> MLGraph:
    """Replace node nid with a set of new nodes; refs to nid point at new_out."""
    nodes: List[MLNode] = []
    for n in g.nodes:
        if n.id == nid:
            nodes.extend(new_nodes)
            continue
        args = tuple(("node", new_out) if r == ("node", nid) else r for r in n.args)
        nodes.append(MLNode(id=n.id, atom=n.atom, args=args))
    out = new_out if g.out == nid else g.out
    return MLGraph(nodes=nodes, out=out, n_inputs=g.n_inputs)


def is_chain(g: MLGraph) -> bool:
    if g.n_inputs != 1:
        return False
    prev: Any = ("in", 0)
    for n in g.nodes:
        if n.args != (prev,):
            return False
        prev = ("node", n.id)
    return g.out == g.nodes[-1].id


# ---------------------------------------------------------------------------
# Rule base + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RuleConfig:
    rule: str
    params: Tuple[Tuple[str, Any], ...]  # sorted kv pairs (hashable)

    def get(self, key, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    @staticmethod
    def make(rule: str, **kw) -> "RuleConfig":
        return RuleConfig(rule=rule, params=tuple(sorted(kw.items())))


class Rule:
    name: str = "?"
    category: str = "?"

    def configs(self, plan: ir.Plan, catalog: ir.Catalog) -> List[RuleConfig]:
        raise NotImplementedError

    def apply(self, plan: ir.Plan, catalog: ir.Catalog, cfg: RuleConfig) -> ir.Plan:
        raise NotImplementedError


ALL_RULES: Dict[str, Rule] = {}


def register_rule(cls):
    inst = cls()
    ALL_RULES[inst.name] = inst
    return cls


def rule_by_name(name: str) -> Rule:
    return ALL_RULES[name]


_fresh_counter = [0]


def fresh_col(base: str) -> str:
    _fresh_counter[0] += 1
    return f"_{base}{_fresh_counter[0]}"
