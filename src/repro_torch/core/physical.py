"""Physical plan layer: operators the backend actually runs.

Produced from the logical IR by ``repro_torch.core.lowering.lower``; executed
by ``run`` below. Physical nodes are where realization choices live; the
logical tree never carries mode/backend/tile decisions (those are
``ir.Plan`` side-table annotations consumed at lowering time).

Operators:
  PScan            : catalog table lookup.
  PPipeline        : a fused chain of row-local stages (Filter / Project /
                     Compact), executed one table pass per stage without
                     per-node interpreter dispatch (Velox-style driver).
  PJoin/PCrossJoin : relational joins (repro_torch.relational.ops).
  PAggregate       : group-by.
  PBlockedMatmul   : R3-1 realization: 'relational' streams the weight-tile
                     relation (paper Fig. 2); 'fused' is the pipelined blocked
                     matmul; backend 'kernel' runs the block_matmul kernel.
  PForestRelational: R3-2 realization: 'relational' streams the tree
                     relation; 'fused' evaluates the ensemble per row;
                     backend 'kernel' runs the decision_forest kernel.

PyTorch runs eagerly, so the tile and tree streams are Python loops.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import ir
from repro_torch.core.evaluator import as_column, eval_expr
from repro_torch.mlfuncs.registry import Registry
from repro_torch.relational import ops
from repro_torch.relational.table import Table


# ---------------------------------------------------------------------------
# pipeline stages (row-local, fusable)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FilterStage:
    pred: ir.Expr

    def signature(self) -> str:
        return f"f[{ir._expr_sig(self.pred)}]"


@dataclasses.dataclass(frozen=True)
class ProjectStage:
    outputs: Tuple[Tuple[str, ir.Expr], ...]
    keep: Optional[Tuple[str, ...]] = None

    def signature(self) -> str:
        outs = ",".join(f"{n}={ir._expr_sig(e)}" for n, e in self.outputs)
        return f"p[{outs};{self.keep}]"


@dataclasses.dataclass(frozen=True)
class CompactStage:
    capacity: int

    def signature(self) -> str:
        return f"c[{self.capacity}]"


Stage = Union[FilterStage, ProjectStage, CompactStage]


# ---------------------------------------------------------------------------
# physical operators
# ---------------------------------------------------------------------------

class PhysNode:
    def children(self) -> Tuple["PhysNode", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class PScan(PhysNode):
    table: str


@dataclasses.dataclass(frozen=True)
class PPipeline(PhysNode):
    child: PhysNode
    stages: Tuple[Stage, ...]

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class PJoin(PhysNode):
    left: PhysNode
    right: PhysNode
    left_key: str
    right_key: str
    rprefix: str = ""

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class PCrossJoin(PhysNode):
    left: PhysNode
    right: PhysNode
    aprefix: str = ""
    bprefix: str = ""

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class PAggregate(PhysNode):
    child: PhysNode
    key: str
    aggs: Tuple[Tuple[str, Tuple[str, str]], ...]
    num_groups: int

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class PBlockedMatmul(PhysNode):
    child: PhysNode
    x_col: str
    out_col: str
    fn: str
    n_tiles: int
    mode: str          # 'relational' | 'fused'
    backend: str       # 'torch' | 'kernel'
    keep: Optional[Tuple[str, ...]] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class PForestRelational(PhysNode):
    child: PhysNode
    x_col: str
    out_col: str
    fn: str
    mode: str
    backend: str
    keep: Optional[Tuple[str, ...]] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    root: PhysNode
    registry: Registry

    def signature(self) -> str:
        return phys_signature(self.root)


def phys_signature(node: PhysNode) -> str:
    if isinstance(node, PScan):
        return f"S({node.table})"
    if isinstance(node, PPipeline):
        stages = "|".join(s.signature() for s in node.stages)
        return f"PIPE({stages};{phys_signature(node.child)})"
    if isinstance(node, PJoin):
        return (f"J({node.left_key}={node.right_key},"
                f"{phys_signature(node.left)},{phys_signature(node.right)})")
    if isinstance(node, PCrossJoin):
        return f"X({phys_signature(node.left)},{phys_signature(node.right)})"
    if isinstance(node, PAggregate):
        aggs = ",".join(f"{o}={k}:{c}" for o, (k, c) in node.aggs)
        return f"A({node.key};{aggs};{phys_signature(node.child)})"
    if isinstance(node, PBlockedMatmul):
        return (f"BM({node.x_col}->{node.out_col},{node.fn},{node.n_tiles},"
                f"{node.mode},{node.backend},{phys_signature(node.child)})")
    if isinstance(node, PForestRelational):
        return (f"FR({node.x_col}->{node.out_col},{node.fn},{node.mode},"
                f"{node.backend},{phys_signature(node.child)})")
    raise TypeError(type(node))


# ---------------------------------------------------------------------------
# realizations of R3-1 / R3-2
# ---------------------------------------------------------------------------

def matmul_weight(registry: Registry, fn_name: str, device) -> torch.Tensor:
    fn = registry.get(fn_name)
    assert fn.graph is not None and len(fn.graph.nodes) == 1
    atom = fn.graph.nodes[0].atom
    assert atom.kind == "matmul", f"{fn_name} is not a pure matmul"
    return atom.param("w", device)


def _weight_tiles(w: torch.Tensor, n_tiles: int):
    """Column tiles [n_tiles, din, tile] of w, the last one zero-padded."""
    din, dout = w.shape
    tile = -(-dout // n_tiles)  # ceil
    wp = torch.nn.functional.pad(w, (0, tile * n_tiles - dout))
    return wp.reshape(din, n_tiles, tile).permute(1, 0, 2), tile


def blocked_matmul_fused(x: torch.Tensor, w: torch.Tensor, n_tiles: int,
                         backend: str) -> torch.Tensor:
    """Pipelined tile-at-a-time matmul over column blocks of w."""
    if backend == "kernel":
        from repro_torch.kernels.block_matmul import ops as bm_ops
        return bm_ops.block_matmul(x.contiguous(), w, n_tiles)
    tiles, _ = _weight_tiles(w, n_tiles)
    blocks = [x @ wt for wt in tiles]                  # one tile at a time
    return torch.cat(blocks, dim=1)[:, :w.shape[1]]


def blocked_matmul_relational(t: Table, x_col: str, w: torch.Tensor,
                              n_tiles: int) -> torch.Tensor:
    """Literal tensor-relational pipeline (paper Fig. 2):
    tile relation W(colId, tile) -> crossJoin -> project -> assemble.

    The crossJoin is *streamed* one tile at a time (the paper's buffer-pool
    scan / Velox pipelining): each step joins T with a single-tile relation,
    projects the per-pair block, and emits it; assembly concatenates blocks
    per rowId.
    """
    din = w.shape[0]
    tiles, tile = _weight_tiles(w, n_tiles)
    x = t[x_col]
    rows = Table(columns={x_col: x}, valid=t.valid)
    blocks = []
    for wt in tiles:
        # one-tile relation, crossJoin with T (trivially T rows), project
        one = Table(columns={"tile": wt.reshape(1, -1)},
                    valid=torch.ones((1,), dtype=torch.bool, device=x.device))
        pairs = ops.cross_join(rows, one)
        wt_full = pairs["tile"].reshape(-1, din, tile)
        blocks.append(torch.einsum("nd,ndk->nk", pairs[x_col], wt_full))
    return torch.cat(blocks, dim=1)[:, :w.shape[1]]


def forest_fused(x: torch.Tensor, fn, backend: str) -> torch.Tensor:
    atom = fn.graph.nodes[0].atom
    if backend == "kernel":
        from repro_torch.kernels.decision_forest import ops as df_ops
        feat, thresh, leaf = (atom.param(n, x.device) for n in ("feat", "thresh", "leaf"))
        return df_ops.forest_predict(x.contiguous(), feat, thresh, leaf)
    return atom.apply(x)


def forest_relational(t: Table, x_col: str, fn) -> torch.Tensor:
    """crossJoin(T, DF) -> project t.predict(x) -> aggregate mean by row.

    Streamed one tree at a time (buffer-pool scan over the DF relation):
    each step joins T with a single-tree relation, projects the per-pair
    prediction, and the running aggregate accumulates the vote.
    """
    atom = fn.graph.nodes[0].atom
    x = t[x_col]
    feat, thresh, leaf = (atom.param(n, x.device) for n in ("feat", "thresh", "leaf"))
    depth = int(atom.params["depth"])
    n_trees = feat.shape[0]
    rows = Table(columns={x_col: x}, valid=t.valid)
    one_valid = torch.ones((1,), dtype=torch.bool, device=x.device)
    acc = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for f, th, lv in zip(feat, thresh, leaf):
        one = Table(columns={"feat": f[None], "thresh": th[None], "leaf": lv[None]},
                    valid=one_valid)
        pairs = ops.cross_join(rows, one)
        xp, fp, tp, lp = pairs[x_col], pairs["feat"], pairs["thresh"], pairs["leaf"]
        fp = fp.long().clamp(0, xp.shape[1] - 1)
        node = torch.zeros((xp.shape[0], 1), dtype=torch.long, device=x.device)
        for _ in range(depth):
            fi = torch.gather(fp, 1, node)
            ti = torch.gather(tp, 1, node)
            xv = torch.gather(xp, 1, fi)
            node = 2 * node + 1 + (xv > ti).long()
        leaf_idx = node - (2 ** depth - 1)
        acc = acc + torch.gather(lp, 1, leaf_idx)[:, 0]
    return acc / n_trees


# ---------------------------------------------------------------------------
# physical execution
# ---------------------------------------------------------------------------

def _run_stage(stage: Stage, t: Table, registry: Registry) -> Table:
    if isinstance(stage, FilterStage):
        mask = torch.as_tensor(eval_expr(stage.pred, t, registry)).to(torch.bool)
        return ops.filter_(t, as_column(mask, t.capacity, t.device))
    if isinstance(stage, ProjectStage):
        new_cols = {name: as_column(eval_expr(e, t, registry), t.capacity, t.device)
                    for name, e in stage.outputs}
        return ops.project(t, new_cols, keep=stage.keep)
    if isinstance(stage, CompactStage):
        return ops.compact(t, stage.capacity)
    raise TypeError(type(stage))


def run_node(node: PhysNode, tables: Dict[str, Table],
             registry: Registry) -> Table:
    if isinstance(node, PScan):
        return tables[node.table]
    if isinstance(node, PPipeline):
        t = run_node(node.child, tables, registry)
        for stage in node.stages:
            t = _run_stage(stage, t, registry)
        return t
    if isinstance(node, PJoin):
        lt = run_node(node.left, tables, registry)
        rt = run_node(node.right, tables, registry)
        return ops.fk_join(lt, rt, node.left_key, node.right_key, node.rprefix)
    if isinstance(node, PCrossJoin):
        lt = run_node(node.left, tables, registry)
        rt = run_node(node.right, tables, registry)
        return ops.cross_join(lt, rt, node.aprefix, node.bprefix)
    if isinstance(node, PAggregate):
        t = run_node(node.child, tables, registry)
        return ops.aggregate(t, node.key, dict(node.aggs), node.num_groups)
    if isinstance(node, PBlockedMatmul):
        t = run_node(node.child, tables, registry)
        w = matmul_weight(registry, node.fn, t.device)
        if node.mode == "relational":
            y = blocked_matmul_relational(t, node.x_col, w, node.n_tiles)
        else:
            y = blocked_matmul_fused(t[node.x_col], w, node.n_tiles, node.backend)
        return ops.project(t, {node.out_col: y}, keep=node.keep)
    if isinstance(node, PForestRelational):
        t = run_node(node.child, tables, registry)
        fn = registry.get(node.fn)
        if node.mode == "relational":
            y = forest_relational(t, node.x_col, fn)
        else:
            y = forest_fused(t[node.x_col], fn, node.backend)
        return ops.project(t, {node.out_col: y}, keep=node.keep)
    raise TypeError(type(node))


def run(pplan: PhysicalPlan, tables: Dict[str, Table]) -> Table:
    """Execute a physical plan over ``tables`` (name -> Table)."""
    return run_node(pplan.root, tables, pplan.registry)
