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
  PRepartition     : intra-query partition boundary: converts its child's
                     row distribution (replicated / row-block / hash-bucket
                     over the mesh's data axis) into the one its consumer
                     executes under, by the mesh's collectives.

Partitioning is an explicit per-node decision, not a whole-plan property:
``PhysicalPlan.parts`` is a side table (mirroring ``ir.Plan.phys``) mapping
each node's tree path to the ``PartSpec`` it executes under, and lowering
inserts ``PRepartition`` boundaries exactly where adjacent specs disagree.
Under a row partition every operator body is *unchanged*: each rank runs
the ordinary single-device code on its row block; under a hash partition a
join runs on bucket-masked inputs. So partitioned execution is the same
``run_node`` with a ``mesh`` and an ``axis`` name (every rank of the mesh
runs the plan; ``core.mesh.shard_replicated``).

PyTorch runs eagerly, so the tile and tree streams are Python loops.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.core import ir
from repro_torch.core.evaluator import as_column, eval_expr
from repro_torch.mlfuncs.registry import Registry
from repro_torch.relational import ops
from repro_torch.relational.table import Table


# ---------------------------------------------------------------------------
# PartSpec: how one node's rows are split over the mesh's data axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartSpec:
    """Row distribution of one physical node's output.

    kind : 'rep'  : replicated: every rank holds all rows (the single-device
                    semantics; the default everywhere).
           'row'  : row blocks: rank i holds rows
                    ``[i*ceil(C/ways), (i+1)*ceil(C/ways))`` of the
                    (tail-padded) table; local capacity is the block size.
           'hash' : hash buckets: full capacity everywhere, but rank i's
                    valid mask is restricted to rows whose
                    ``hash_bucket(key) == i`` (static shapes make a
                    compacted bucket capacity unsound under skew: all keys
                    may land in one bucket; so bucket partitioning trades
                    no memory for collective-free local joins).
    """
    kind: str = "rep"
    ways: int = 1
    key: Optional[str] = None  # bucket column ('hash' only)

    def signature(self) -> str:
        if self.kind == "rep":
            return "rep"
        tag = f"{self.kind}{self.ways}"
        return tag + (f"[{self.key}]" if self.key else "")


REPLICATED = PartSpec()


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
class PRepartition(PhysNode):
    """Partition boundary: convert the child's PartSpec into the consumer's.

    op : 'slice'     : replicated -> row: rank i takes its block of the
                       tail-padded table (``out_capacity`` = block size).
         'allgather' : row -> replicated: concatenate all blocks (an
                       all-gather on dim 0) and drop the tail padding back
                       to ``out_capacity`` (the global capacity); row blocks
                       tile the original row order, so the reassembled table
                       is bit-identical to the unpartitioned one.
         'bucket'    : replicated -> hash: mask validity to the rows whose
                       ``hash_bucket(key) == rank``.
         'combine'   : hash -> replicated: zero the rows a rank does not own
                       and all-reduce columns + masks with SUM (each valid
                       row is owned by exactly one rank, so the sum is
                       exact, including total skew, where one rank owns all).
    """
    child: PhysNode
    op: str
    ways: int
    in_capacity: int
    out_capacity: int
    key: Optional[str] = None  # bucket column ('bucket' only)

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    root: PhysNode
    registry: Registry
    # PartSpec side table (mirrors ir.Plan.phys): node tree path -> the
    # spec the node executes under. "r" is the root, "r.0" its first
    # child, ... Empty on unpartitioned plans; purely descriptive at run
    # time (execution follows the explicit PRepartition boundaries).
    parts: Mapping[str, PartSpec] = dataclasses.field(default_factory=dict)
    ways: int = 1  # >1 iff any node's spec is partitioned

    def signature(self) -> str:
        return phys_signature(self.root)

    def part_for(self, path: str) -> PartSpec:
        return self.parts.get(path, REPLICATED)

    def part_signature(self) -> str:
        """The PartSpec vector, compact and stable (cache-key material):
        only non-replicated entries, in tree-path order."""
        items = [f"{p}={s.signature()}" for p, s in sorted(self.parts.items())
                 if s.kind != "rep"]
        return ",".join(items) if items else "rep"


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
    if isinstance(node, PRepartition):
        return (f"RP({node.op},{node.ways},{node.key},{node.in_capacity}"
                f"->{node.out_capacity},{phys_signature(node.child)})")
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
# repartition boundaries (the mesh's collectives)
# ---------------------------------------------------------------------------

def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Append ``n`` zero rows (False for the valid mask) at the tail."""
    if n <= 0:
        return x
    return torch.cat([x, x.new_zeros((n,) + tuple(x.shape[1:]))])


def run_repartition(node: PRepartition, t: Table, mesh,
                    axis: Optional[str]) -> Table:
    from repro_torch.core import mesh as mesh_util

    if mesh is None or axis is None:
        raise RuntimeError(
            f"PRepartition({node.op}) needs a mesh axis: partitioned plans "
            "execute on every rank of a mesh (core.mesh.shard_replicated); "
            "see PlanCache.get_or_compile_partitioned")
    i = mesh_util.rank_of(mesh, axis)
    if node.op == "slice":
        block = node.out_capacity
        pad = block * node.ways - t.capacity

        def sl(x):
            return _pad_rows(x, pad)[i * block:(i + 1) * block]

        return Table(columns={k: sl(v) for k, v in t.columns.items()},
                     valid=sl(t.valid))
    if node.op == "allgather":
        # blocks tile the (tail-padded) original row order: concatenating
        # them and slicing off the padding restores the exact global table
        def ag(x):
            return mesh_util.all_gather_rows(x, mesh, axis)[:node.out_capacity]

        return Table(columns={k: ag(v) for k, v in t.columns.items()},
                     valid=ag(t.valid))
    if node.op == "bucket":
        own = mesh_util.hash_bucket(t[node.key], node.ways) == i
        return Table(columns=t.columns, valid=t.valid & own)
    if node.op == "combine":
        # each valid row is owned by exactly one rank: zero the rest and
        # sum; exact for ints, and exact for floats too (x + 0.0 == x)
        def cb(x):
            m = t.valid.reshape((-1,) + (1,) * (x.ndim - 1))
            return mesh_util.all_reduce_sum(
                torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device)),
                mesh, axis)

        return Table(columns={k: cb(v) for k, v in t.columns.items()},
                     valid=mesh_util.all_reduce_sum(t.valid, mesh, axis))
    raise ValueError(f"unknown repartition op {node.op!r}")


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
             registry: Registry, mesh=None, axis: Optional[str] = None) -> Table:
    if isinstance(node, PScan):
        return tables[node.table]
    if isinstance(node, PPipeline):
        t = run_node(node.child, tables, registry, mesh, axis)
        for stage in node.stages:
            t = _run_stage(stage, t, registry)
        return t
    if isinstance(node, PJoin):
        lt = run_node(node.left, tables, registry, mesh, axis)
        rt = run_node(node.right, tables, registry, mesh, axis)
        return ops.fk_join(lt, rt, node.left_key, node.right_key, node.rprefix)
    if isinstance(node, PCrossJoin):
        lt = run_node(node.left, tables, registry, mesh, axis)
        rt = run_node(node.right, tables, registry, mesh, axis)
        return ops.cross_join(lt, rt, node.aprefix, node.bprefix)
    if isinstance(node, PAggregate):
        t = run_node(node.child, tables, registry, mesh, axis)
        return ops.aggregate(t, node.key, dict(node.aggs), node.num_groups)
    if isinstance(node, PBlockedMatmul):
        t = run_node(node.child, tables, registry, mesh, axis)
        w = matmul_weight(registry, node.fn, t.device)
        if node.mode == "relational":
            y = blocked_matmul_relational(t, node.x_col, w, node.n_tiles)
        else:
            y = blocked_matmul_fused(t[node.x_col], w, node.n_tiles, node.backend)
        return ops.project(t, {node.out_col: y}, keep=node.keep)
    if isinstance(node, PForestRelational):
        t = run_node(node.child, tables, registry, mesh, axis)
        fn = registry.get(node.fn)
        if node.mode == "relational":
            y = forest_relational(t, node.x_col, fn)
        else:
            y = forest_fused(t[node.x_col], fn, node.backend)
        return ops.project(t, {node.out_col: y}, keep=node.keep)
    if isinstance(node, PRepartition):
        t = run_node(node.child, tables, registry, mesh, axis)
        return run_repartition(node, t, mesh, axis)
    raise TypeError(type(node))


def run(pplan: PhysicalPlan, tables: Dict[str, Table], mesh=None,
        axis: Optional[str] = None) -> Table:
    """Execute a physical plan over ``tables`` (name -> Table). ``mesh`` and
    ``axis`` name the mesh dimension a *partitioned* plan's repartition
    boundaries collect over (every rank of it runs this call); unpartitioned
    plans (no PRepartition nodes) ignore them."""
    return run_node(pplan.root, tables, pplan.registry, mesh, axis)
