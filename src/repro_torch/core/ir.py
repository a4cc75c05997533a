"""Logical Intermediate Representation (paper Sec. III).

Top level    : relational operators (``RelNode`` subclasses) — each Filter /
               Project is customized by expressions that are opaque *at this
               level*.
Middle level : expression trees (``Expr`` subclasses) — arithmetic, compare,
               boolean, conditional, and CALLFUNC nodes.
Bottom level : ``Call`` resolves through the ML-function ``Registry`` to an
               ``MLGraph`` of atomic ML functions (repro_torch.mlfuncs).

The *physical* level (repro_torch.core.physical) is produced from this IR by
repro_torch.core.lowering; logical nodes carry only semantics. Physical choices
(realization mode, kernel backend, tile counts) live in a side table on the
``Plan`` (``Plan.phys``), keyed by the stable ``uid`` of the annotated node,
so optimizer rules can re-realize a sub-computation without rebuilding the
logical tree.

A ``Plan`` bundles (root RelNode, Registry, physical side table); a
``Catalog`` holds base tables and their statistics (row counts, per-column
min/max/histograms — the E_h / E_s features of Query2Vec).

All IR nodes are immutable; rewrites build new trees with structural sharing.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.mlfuncs.registry import Registry


# ===========================================================================
# Middle-level IR: expressions
# ===========================================================================

class Expr:
    def cols(self) -> frozenset:
        raise NotImplementedError

    def children(self) -> Tuple["Expr", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    name: str

    def cols(self):
        return frozenset([self.name])


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float

    def cols(self):
        return frozenset()


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * /
    a: Expr
    b: Expr

    def cols(self):
        return self.a.cols() | self.b.cols()

    def children(self):
        return (self.a, self.b)


@dataclasses.dataclass(frozen=True)
class Cmp(Expr):
    op: str  # > < >= <= == !=
    a: Expr
    b: Expr

    def cols(self):
        return self.a.cols() | self.b.cols()

    def children(self):
        return (self.a, self.b)


@dataclasses.dataclass(frozen=True)
class BoolOp(Expr):
    op: str  # and or not
    args: Tuple[Expr, ...]

    def cols(self):
        s = frozenset()
        for a in self.args:
            s |= a.cols()
        return s

    def children(self):
        return self.args


@dataclasses.dataclass(frozen=True)
class IsIn(Expr):
    """Set membership on an integer-coded categorical column — our stand-in
    for the paper's LIKE '%Action%' genre predicates."""
    a: Expr
    values: Tuple[int, ...]

    def cols(self):
        return self.a.cols()

    def children(self):
        return (self.a,)


@dataclasses.dataclass(frozen=True)
class IfExpr(Expr):
    cond: Expr
    t: Expr
    f: Expr

    def cols(self):
        return self.cond.cols() | self.t.cols() | self.f.cols()

    def children(self):
        return (self.cond, self.t, self.f)


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """CALLFUNC — invoke a registered ML function on column expressions."""
    fn: str
    args: Tuple[Expr, ...]

    def cols(self):
        s = frozenset()
        for a in self.args:
            s |= a.cols()
        return s

    def children(self):
        return self.args


# ===========================================================================
# Top-level IR: relational operators
# ===========================================================================

class RelNode:
    def children(self) -> Tuple["RelNode", ...]:
        raise NotImplementedError

    def with_children(self, children: Sequence["RelNode"]) -> "RelNode":
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Scan(RelNode):
    table: str

    def children(self):
        return ()

    def with_children(self, children):
        assert not children
        return self


@dataclasses.dataclass(frozen=True)
class Filter(RelNode):
    child: RelNode
    pred: Expr
    selectivity: Optional[float] = None  # user/optimizer hint

    def children(self):
        return (self.child,)

    def with_children(self, children):
        return dataclasses.replace(self, child=children[0])


@dataclasses.dataclass(frozen=True)
class Project(RelNode):
    """Adds computed columns. ``keep=None`` keeps all input columns;
    otherwise only ``keep`` plus the new outputs survive."""
    child: RelNode
    outputs: Tuple[Tuple[str, Expr], ...]
    keep: Optional[Tuple[str, ...]] = None

    def children(self):
        return (self.child,)

    def with_children(self, children):
        return dataclasses.replace(self, child=children[0])

    def outputs_dict(self) -> Dict[str, Expr]:
        return dict(self.outputs)


@dataclasses.dataclass(frozen=True)
class Join(RelNode):
    """FK inner equi-join (right side unique on key)."""
    left: RelNode
    right: RelNode
    left_key: str
    right_key: str
    rprefix: str = ""

    def children(self):
        return (self.left, self.right)

    def with_children(self, children):
        return dataclasses.replace(self, left=children[0], right=children[1])


@dataclasses.dataclass(frozen=True)
class CrossJoin(RelNode):
    left: RelNode
    right: RelNode
    aprefix: str = ""
    bprefix: str = ""

    def children(self):
        return (self.left, self.right)

    def with_children(self, children):
        return dataclasses.replace(self, left=children[0], right=children[1])


@dataclasses.dataclass(frozen=True)
class Aggregate(RelNode):
    child: RelNode
    key: str
    aggs: Tuple[Tuple[str, Tuple[str, str]], ...]  # out -> (kind, in_col)
    num_groups: int

    def children(self):
        return (self.child,)

    def with_children(self, children):
        return dataclasses.replace(self, child=children[0])


@dataclasses.dataclass(frozen=True)
class Compact(RelNode):
    """Physical: gather live rows into a smaller static capacity. Inserted by
    the optimizer after selective filters: downstream per-row compute is
    proportional to capacity, not to live rows."""
    child: RelNode
    capacity: int

    def children(self):
        return (self.child,)

    def with_children(self, children):
        return dataclasses.replace(self, child=children[0])


_uid_counter = itertools.count()


def fresh_uid() -> str:
    """Stable identity for side-table annotations; survives with_children /
    dataclasses.replace rewrites and is excluded from structural equality."""
    return f"n{next(_uid_counter)}"


@dataclasses.dataclass(frozen=True)
class BlockedMatmul(RelNode):
    """Logical node produced by R3-1 (tensor-relational matMul).

    Semantics only: out_col[i] = x_col[i] @ W, where W is the weight of the
    (matmul-only) registered function ``fn``. The physical realization
    (relational vs fused pipeline, torch vs kernel backend, tile count) is an
    annotation in ``Plan.phys`` keyed by ``uid`` and is chosen at lowering.
    """
    child: RelNode
    x_col: str
    out_col: str
    fn: str
    keep: Optional[Tuple[str, ...]] = None
    uid: str = dataclasses.field(default_factory=fresh_uid, compare=False)

    def children(self):
        return (self.child,)

    def with_children(self, children):
        return dataclasses.replace(self, child=children[0])


@dataclasses.dataclass(frozen=True)
class ForestRelational(RelNode):
    """Logical node produced by R3-2 (forest → crossJoin+project+aggregate).

    Semantics only: out_col[i] = forest_vote(x_col[i]). Whether the forest is
    realized relationally (crossJoin with the tree relation DF(treeId, feat,
    thresh, leaf) + aggregate) or fused per row, and on which backend, is a
    ``Plan.phys`` annotation keyed by ``uid``.
    """
    child: RelNode
    x_col: str
    out_col: str
    fn: str
    keep: Optional[Tuple[str, ...]] = None
    uid: str = dataclasses.field(default_factory=fresh_uid, compare=False)

    def children(self):
        return (self.child,)

    def with_children(self, children):
        return dataclasses.replace(self, child=children[0])


# ===========================================================================
# Physical configuration side table (annotations on Plan, consumed by
# repro_torch.core.lowering)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class PhysConfig:
    """Physical realization choice for one BlockedMatmul/ForestRelational.

    mode    : 'relational' — literal tile/tree relation + crossJoin pipeline
              (paper Fig. 2); 'fused' — pipelined evaluation without
              materializing the product (Velox-style).
    backend : 'torch' (ATen ops) | 'kernel' (hand-written Hopper kernels).
    n_tiles : weight-tile count for BlockedMatmul streaming.
    """
    mode: str = "fused"
    backend: str = "torch"
    n_tiles: int = 4

    def signature(self) -> str:
        return f"{self.mode}/{self.backend}/{self.n_tiles}"


DEFAULT_PHYS = PhysConfig()


def default_n_tiles(registry: Registry, fn_name: str) -> int:
    """Tile-count policy for a blocked matmul: ~1MB per weight tile, clamped
    to [2, 16]. The single source of truth — R3-1 annotations, lowering
    defaults, the cost model, and the featurizer all resolve through here."""
    try:
        fn = registry.get(fn_name)
        w = np.asarray(fn.graph.nodes[0].atom.params["w"])
        return int(max(2, min(16, np.ceil(w.nbytes / (1 << 20)))))
    except Exception:
        return DEFAULT_PHYS.n_tiles


def resolve_phys(node: RelNode, phys: Optional[Mapping[str, PhysConfig]],
                 registry: Registry) -> PhysConfig:
    """The PhysConfig a node will actually execute with: its side-table
    annotation, or the default with a weight-derived tile count."""
    uid = getattr(node, "uid", "")
    cfg = (phys or {}).get(uid, DEFAULT_PHYS)
    if isinstance(node, BlockedMatmul) and uid not in (phys or {}):
        cfg = dataclasses.replace(cfg,
                                  n_tiles=default_n_tiles(registry, node.fn))
    return cfg


# ===========================================================================
# Catalog + Plan
# ===========================================================================

@dataclasses.dataclass
class ColumnStats:
    dim: int                 # 0 = scalar, d = vector
    min: float = 0.0
    max: float = 1.0
    histogram: Optional[np.ndarray] = None  # 8-bin equi-width (scalar cols)


@dataclasses.dataclass
class TableStats:
    rows: int
    capacity: int
    columns: Dict[str, ColumnStats]
    sample_bitmap: Optional[np.ndarray] = None  # E_s feature (64 samples)


class Catalog:
    """Base tables (torch Tables) + numpy copies for the oracle + stats."""

    def __init__(self) -> None:
        self.tables: Dict[str, "object"] = {}
        self.np_tables: Dict[str, Dict[str, np.ndarray]] = {}
        self.stats: Dict[str, TableStats] = {}

    def add(self, name: str, table) -> None:
        from repro_torch.relational.table import Table  # local import to avoid cycle
        assert isinstance(table, Table)
        self.tables[name] = table
        npt = table.to_numpy()
        self.np_tables[name] = npt
        cols: Dict[str, ColumnStats] = {}
        for cname, arr in npt.items():
            if arr.ndim == 1:
                a = arr.astype(np.float64)
                hist = np.histogram(a, bins=8)[0].astype(np.float32) if len(a) else None
                if hist is not None and hist.sum() > 0:
                    hist = hist / hist.sum()
                cols[cname] = ColumnStats(dim=0,
                                          min=float(a.min()) if len(a) else 0.0,
                                          max=float(a.max()) if len(a) else 1.0,
                                          histogram=hist)
            else:
                cols[cname] = ColumnStats(dim=int(arr.shape[1]))
        rng = np.random.default_rng(0)
        n = len(next(iter(npt.values()))) if npt else 0
        bitmap = (rng.random(64) < min(1.0, n / max(n, 1))).astype(np.float32) if n else None
        self.stats[name] = TableStats(rows=n, capacity=table.capacity,
                                      columns=cols, sample_bitmap=bitmap)


@dataclasses.dataclass
class Plan:
    root: RelNode
    registry: Registry
    # physical side table: node uid -> PhysConfig (logical tree stays pure)
    phys: Mapping[str, PhysConfig] = dataclasses.field(default_factory=dict)

    def replace_root(self, root: RelNode) -> "Plan":
        return Plan(root=root, registry=self.registry, phys=self.phys)

    def with_phys(self, uid: str, cfg: PhysConfig) -> "Plan":
        return Plan(root=self.root, registry=self.registry,
                    phys={**self.phys, uid: cfg})

    def phys_for(self, node: RelNode) -> PhysConfig:
        return resolve_phys(node, self.phys, self.registry)

    def signature(self) -> str:
        """Structural + physical-config signature (plan cache / embed keys)."""
        return plan_signature(self.root, self.phys)


# ===========================================================================
# Schema / stats propagation (used by rules + cost model + embeddings)
# ===========================================================================

@dataclasses.dataclass
class NodeInfo:
    schema: Dict[str, int]     # column -> dim
    rows: float                # live-row estimate
    capacity: int              # static capacity


def expr_dim(e: Expr, schema: Mapping[str, int], registry: Registry) -> int:
    if isinstance(e, Col):
        return schema[e.name]
    if isinstance(e, Const):
        return 0
    if isinstance(e, (BinOp,)):
        return max(expr_dim(e.a, schema, registry), expr_dim(e.b, schema, registry))
    if isinstance(e, (Cmp, BoolOp, IsIn)):
        return 0
    if isinstance(e, IfExpr):
        return max(expr_dim(e.t, schema, registry), expr_dim(e.f, schema, registry))
    if isinstance(e, Call):
        fn = registry.get(e.fn)
        in_dims = [expr_dim(a, schema, registry) for a in e.args]
        d = fn.out_dim(in_dims)
        return 0 if d <= 1 else d  # dim-1 vectors are scalar columns
    raise TypeError(type(e))


def expr_flops(e: Expr, schema: Mapping[str, int], registry: Registry) -> float:
    """FLOPs per row to evaluate the expression."""
    if isinstance(e, (Col, Const)):
        return 0.0
    if isinstance(e, (BinOp, Cmp)):
        d = max(1, expr_dim(e, schema, registry))
        return expr_flops(e.a, schema, registry) + expr_flops(e.b, schema, registry) + d
    if isinstance(e, BoolOp):
        return sum(expr_flops(a, schema, registry) for a in e.args) + 1
    if isinstance(e, IsIn):
        return expr_flops(e.a, schema, registry) + len(e.values)
    if isinstance(e, IfExpr):
        return (expr_flops(e.cond, schema, registry) + expr_flops(e.t, schema, registry)
                + expr_flops(e.f, schema, registry) + 1)
    if isinstance(e, Call):
        fn = registry.get(e.fn)
        in_dims = [expr_dim(a, schema, registry) for a in e.args]
        return (sum(expr_flops(a, schema, registry) for a in e.args)
                + fn.flops_per_row(in_dims))
    raise TypeError(type(e))


def estimate_selectivity(pred: Expr, schema, registry, catalog: Optional[Catalog],
                         table_hint: Optional[str] = None) -> float:
    """Crude selectivity estimate; ML predicates fall back to fn hints."""
    if isinstance(pred, BoolOp):
        sels = [estimate_selectivity(a, schema, registry, catalog, table_hint)
                for a in pred.args]
        if pred.op == "and":
            out = 1.0
            for s in sels:
                out *= s
            return out
        if pred.op == "or":
            out = 0.0
            for s in sels:
                out = out + s - out * s
            return out
        return max(0.0, 1.0 - sels[0])
    if isinstance(pred, Cmp):
        # uniform-assumption range estimate when one side is Const over a Col
        col, const = None, None
        if isinstance(pred.a, Col) and isinstance(pred.b, Const):
            col, const, op = pred.a, pred.b.value, pred.op
        elif isinstance(pred.b, Col) and isinstance(pred.a, Const):
            flip = {">": "<", "<": ">", ">=": "<=", "<=": ">="}
            col, const, op = pred.b, pred.a.value, flip.get(pred.op, pred.op)
        if col is not None and catalog is not None and table_hint is not None:
            st = catalog.stats.get(table_hint)
            if st and col.name in st.columns and st.columns[col.name].dim == 0:
                cs = st.columns[col.name]
                span = max(cs.max - cs.min, 1e-9)
                frac = float(np.clip((const - cs.min) / span, 0.0, 1.0))
                if op in ("<", "<="):
                    return max(frac, 1e-3)
                if op in (">", ">="):
                    return max(1.0 - frac, 1e-3)
                if op == "==":
                    return 0.05
                return 0.95
        return 0.33 if pred.op in (">", "<", ">=", "<=") else 0.1
    if isinstance(pred, IsIn):
        return min(1.0, 0.1 * len(pred.values) + 0.05)
    if isinstance(pred, Call):
        fn = registry.get(pred.fn)
        return fn.selectivity_hint if fn.selectivity_hint is not None else 0.5
    return 0.5


def infer(node: RelNode, registry: Registry, catalog: Catalog) -> NodeInfo:
    """Bottom-up schema + cardinality inference."""
    if isinstance(node, Scan):
        st = catalog.stats[node.table]
        return NodeInfo(schema={c: s.dim for c, s in st.columns.items()},
                        rows=float(st.rows), capacity=st.capacity)
    if isinstance(node, Filter):
        ci = infer(node.child, registry, catalog)
        sel = node.selectivity
        if sel is None:
            hint = _base_table_hint(node.child)
            sel = estimate_selectivity(node.pred, ci.schema, registry, catalog, hint)
        return NodeInfo(schema=ci.schema, rows=ci.rows * sel, capacity=ci.capacity)
    if isinstance(node, Compact):
        ci = infer(node.child, registry, catalog)
        return NodeInfo(schema=ci.schema, rows=min(ci.rows, node.capacity),
                        capacity=node.capacity)
    if isinstance(node, Project):
        ci = infer(node.child, registry, catalog)
        schema = dict(ci.schema) if node.keep is None else {k: ci.schema[k] for k in node.keep}
        for name, e in node.outputs:
            schema[name] = expr_dim(e, ci.schema, registry)
        return NodeInfo(schema=schema, rows=ci.rows, capacity=ci.capacity)
    if isinstance(node, Join):
        li = infer(node.left, registry, catalog)
        ri = infer(node.right, registry, catalog)
        schema = dict(li.schema)
        for c, d in ri.schema.items():
            out = node.rprefix + c
            if out == node.left_key and c == node.right_key:
                continue
            schema[out] = d
        return NodeInfo(schema=schema, rows=li.rows, capacity=li.capacity)
    if isinstance(node, CrossJoin):
        li = infer(node.left, registry, catalog)
        ri = infer(node.right, registry, catalog)
        schema = {node.aprefix + c: d for c, d in li.schema.items()}
        schema.update({node.bprefix + c: d for c, d in ri.schema.items()})
        return NodeInfo(schema=schema, rows=li.rows * ri.rows,
                        capacity=li.capacity * ri.capacity)
    if isinstance(node, Aggregate):
        ci = infer(node.child, registry, catalog)
        schema = {node.key: 0}
        for out, (kind, in_col) in node.aggs:
            schema[out] = 0 if kind == "count" else ci.schema.get(in_col, 0)
        rows = min(ci.rows, node.num_groups)
        return NodeInfo(schema=schema, rows=rows, capacity=node.num_groups)
    if isinstance(node, BlockedMatmul):
        ci = infer(node.child, registry, catalog)
        fn = registry.get(node.fn)
        schema = dict(ci.schema) if node.keep is None else {k: ci.schema[k] for k in node.keep}
        schema[node.out_col] = fn.out_dim([ci.schema[node.x_col]])
        return NodeInfo(schema=schema, rows=ci.rows, capacity=ci.capacity)
    if isinstance(node, ForestRelational):
        ci = infer(node.child, registry, catalog)
        schema = dict(ci.schema) if node.keep is None else {k: ci.schema[k] for k in node.keep}
        schema[node.out_col] = 0
        return NodeInfo(schema=schema, rows=ci.rows, capacity=ci.capacity)
    raise TypeError(type(node))


def _base_table_hint(node: RelNode) -> Optional[str]:
    while True:
        if isinstance(node, Scan):
            return node.table
        kids = node.children()
        if len(kids) != 1:
            return None
        node = kids[0]


# -- tree utilities ----------------------------------------------------------

def walk(node: RelNode):
    yield node
    for c in node.children():
        yield from walk(c)


def replace_node(root: RelNode, old: RelNode, new: RelNode) -> RelNode:
    if root is old:
        return new
    kids = root.children()
    if not kids:
        return root
    new_kids = tuple(replace_node(c, old, new) for c in kids)
    if all(a is b for a, b in zip(kids, new_kids)):
        return root
    return root.with_children(new_kids)


def plan_signature(node: RelNode,
                   phys: Optional[Mapping[str, PhysConfig]] = None) -> str:
    """Structural string (used for dedup in search and as cache keys).

    With ``phys`` given, BlockedMatmul/ForestRelational signatures include
    their physical-config annotation so plans that differ only in realization
    (the R4-2 choices) key distinctly.
    """
    if isinstance(node, Scan):
        return f"S({node.table})"
    if isinstance(node, Filter):
        return f"F({_expr_sig(node.pred)},{plan_signature(node.child, phys)})"
    if isinstance(node, Compact):
        return f"C({node.capacity},{plan_signature(node.child, phys)})"
    if isinstance(node, Project):
        outs = ",".join(f"{n}={_expr_sig(e)}" for n, e in node.outputs)
        return f"P({outs};{node.keep};{plan_signature(node.child, phys)})"
    if isinstance(node, Join):
        return (f"J({node.left_key}={node.right_key},"
                f"{plan_signature(node.left, phys)},"
                f"{plan_signature(node.right, phys)})")
    if isinstance(node, CrossJoin):
        return (f"X({plan_signature(node.left, phys)},"
                f"{plan_signature(node.right, phys)})")
    if isinstance(node, Aggregate):
        aggs = ",".join(f"{o}={k}:{c}" for o, (k, c) in node.aggs)
        return f"A({node.key};{aggs};{plan_signature(node.child, phys)})"
    if isinstance(node, (BlockedMatmul, ForestRelational)):
        cfg = (phys or {}).get(node.uid, DEFAULT_PHYS)
        tag = "BM" if isinstance(node, BlockedMatmul) else "FR"
        return (f"{tag}({node.x_col}->{node.out_col},{node.fn},"
                f"{cfg.signature()},{plan_signature(node.child, phys)})")
    raise TypeError(type(node))


def _expr_sig(e: Expr) -> str:
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Const):
        return f"{e.value:g}"
    if isinstance(e, BinOp):
        return f"({_expr_sig(e.a)}{e.op}{_expr_sig(e.b)})"
    if isinstance(e, Cmp):
        return f"({_expr_sig(e.a)}{e.op}{_expr_sig(e.b)})"
    if isinstance(e, BoolOp):
        return f"{e.op}({','.join(_expr_sig(a) for a in e.args)})"
    if isinstance(e, IsIn):
        return f"in({_expr_sig(e.a)},{self_values(e)})"
    if isinstance(e, IfExpr):
        return f"if({_expr_sig(e.cond)},{_expr_sig(e.t)},{_expr_sig(e.f)})"
    if isinstance(e, Call):
        return f"{e.fn}({','.join(_expr_sig(a) for a in e.args)})"
    raise TypeError(type(e))


def self_values(e: IsIn) -> str:
    return "|".join(str(v) for v in e.values)
