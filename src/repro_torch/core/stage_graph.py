"""Stage-DAG IR: the candidate space of lowering decisions.

``build`` turns a logical plan into a small DAG that mirrors the physical
operator tree but keeps lowering's *choices* open instead of fixing them in
tree order:

* **stage order** — each fused row-local pipeline holds its stages as
  vertices with precedence edges (column read/write conflicts, keep-project
  barriers, filter/compact ordering legality); any topological order is a
  legal realization. Filters keep their relative tree order (reordering
  them is cost-neutral under the capacity-driven model, and fixing them
  keeps every compaction bound sound).
* **compaction placement** — a Filter with a *sound* live-row bound (an
  exact numpy count of its scan-level predicate-chain conjunction, ML
  calls included; never a selectivity estimate — a wrong bound would drop
  rows) offers an optional ``Compact`` stage glued right after it,
  capacity rounded up (headroom against parameterized traffic, same
  policy as the ``compact`` co-optimization rule).
* **realization** — each BlockedMatmul/ForestRelational node that the
  optimizer did *not* explicitly annotate offers mode x backend candidates
  (the kernel backend only on profiles that support it). Explicit ``Plan.phys``
  annotations and caller ``backend=`` overrides are sovereign: the rule
  engine / caller chose, lowering does not second-guess.
* **partitioning** (``ways > 1`` — the intra-query sharding path) — every
  pipeline without a Compact, every ML node, and both join kinds offer
  per-node ``PartSpec`` candidates: row-block partitioning over the
  mesh's data axis (joins: probe side partitioned, build replicated), and
  for ``PJoin`` additionally hash-bucket partitioning of both sides.
  ``realize`` inserts explicit ``PRepartition`` boundaries exactly where
  adjacent nodes' specs disagree (slice / allgather / bucket / combine)
  and records the chosen spec of every node in the physical plan's
  ``parts`` side table. A row-partitioned pipeline containing a Compact is
  split at its last compact stage — the prefix runs replicated (a
  per-block compact would reorder rows against the global compaction),
  the row-local suffix partitions.

``core.costed_lowering`` enumerates the site options and scores realized
candidates through the shared ``cost.plan_cost`` oracle; ``realize`` with
``default_decisions`` reproduces tree-order lowering exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import evaluator, ir
from repro_torch.core import physical as ph
from repro_torch.mlfuncs.registry import Registry

# plan-level realizations resolve per-node to the ATen path (the sharded
# path splits the stacked batch axis *around* the plan body); kept in sync
# with repro_torch.core.lowering._PLAN_LEVEL_BACKENDS
PLAN_LEVEL_BACKENDS = {"sharded": "torch"}

_ROW_LOCAL = (ir.Filter, ir.Project, ir.Compact)

# enumeration bound: per-pipeline topological orders
ORDER_CAP = 8
# exact-count budget: predicate chains are only counted on base tables up
# to this many rows (counting runs the predicate — including ML calls —
# once on the numpy base data; same spirit as the compact rule's 2M cap)
COUNT_ROWS_CAP = 200_000


def _round_up(n: int) -> int:
    """Next power of two >= n (min 8): compaction headroom, same policy as
    the ``compact`` rule in ``rules.o1``."""
    n = max(int(n), 8)
    p = 8
    while p < n:
        p *= 2
    return p


def compact_capacity(bound: float) -> int:
    """Compaction capacity for a sound live-row bound: the next power of
    two, or — when that doubles a large bound away — the next multiple of
    64 above 25% headroom. Headroom is what keeps the capacity a sound
    bound under drifting (parameterized) traffic, same intent as the
    ``compact`` rule's power-of-two policy."""
    b = int(np.ceil(bound))
    return max(min(_round_up(b), int(-(-int(b * 1.25) // 64)) * 64), 8)


# ---------------------------------------------------------------------------
# pipeline vertices + legality edges
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageVertex:
    stage: ph.Stage
    reads: frozenset
    writes: frozenset
    is_filter: bool = False
    is_compact: bool = False
    barrier: bool = False  # keep-projects drop columns: nothing crosses


def _vertex(node: ir.RelNode) -> StageVertex:
    if isinstance(node, ir.Filter):
        return StageVertex(ph.FilterStage(pred=node.pred),
                           reads=frozenset(node.pred.cols()),
                           writes=frozenset(), is_filter=True)
    if isinstance(node, ir.Project):
        reads = frozenset().union(*(e.cols() for _, e in node.outputs)) \
            if node.outputs else frozenset()
        return StageVertex(ph.ProjectStage(outputs=node.outputs,
                                           keep=node.keep),
                           reads=reads,
                           writes=frozenset(n for n, _ in node.outputs),
                           barrier=node.keep is not None)
    if isinstance(node, ir.Compact):
        return StageVertex(ph.CompactStage(capacity=node.capacity),
                           reads=frozenset(), writes=frozenset(),
                           is_compact=True)
    raise TypeError(type(node))


def _edges(vertices: Tuple[StageVertex, ...]) -> frozenset:
    """Precedence edges (i, j): vertex i must stay before vertex j."""
    out = set()
    n = len(vertices)
    for i in range(n):
        for j in range(i + 1, n):
            a, b = vertices[i], vertices[j]
            if (a.barrier or b.barrier
                    or (a.writes & b.reads) or (a.reads & b.writes)
                    or (a.writes & b.writes)
                    # filters keep tree order (cost-neutral; keeps every
                    # compaction bound's filter-conjunction sound)
                    or (a.is_filter and b.is_filter)
                    or (a.is_compact and b.is_compact)
                    # a compact may move *later* across a filter (its bound
                    # held before the filter), never earlier across one
                    or (a.is_filter and b.is_compact)):
                out.add((i, j))
    return frozenset(out)


def _topo_orders(n: int, edges: frozenset, cap: int = ORDER_CAP
                 ) -> Tuple[Tuple[int, ...], ...]:
    """Up to ``cap`` topological orders; index order first, so option 0 is
    always the tree order."""
    preds = {j: {i for (i, jj) in edges if jj == j} for j in range(n)}
    out: List[Tuple[int, ...]] = []

    def rec(prefix: List[int], remaining: List[int]):
        if len(out) >= cap:
            return
        if not remaining:
            out.append(tuple(prefix))
            return
        placed = set(prefix)
        for v in remaining:
            if preds[v] <= placed:
                rec(prefix + [v], [r for r in remaining if r != v])
                if len(out) >= cap:
                    return

    rec([], list(range(n)))
    return tuple(out)


# ---------------------------------------------------------------------------
# sound live-row bounds (compaction legality)
# ---------------------------------------------------------------------------

def _count_cache(catalog: ir.Catalog) -> Dict[tuple, Optional[int]]:
    """Per-catalog count cache, stored *on* the catalog so it dies with it
    (a module-level id(catalog)-keyed dict would both leak and risk serving
    a stale count when a freed catalog's id is reused)."""
    cache = getattr(catalog, "_stage_graph_counts", None)
    if cache is None:
        cache = {}
        catalog._stage_graph_counts = cache
    return cache


def _exact_chain_count(f: ir.Filter, registry: Registry,
                       catalog: ir.Catalog) -> Optional[int]:
    """Exact surviving-row count of a Filter whose subtree is a chain of
    Filters over a Scan — numpy evaluation of the predicate conjunction
    (ML calls included: the unified evaluator runs them under ``xp=np``)
    on the catalog's base data, cached on the catalog per (table,
    predicate chain). Exactness is what makes the count a *sound*
    compaction bound; a selectivity guess here would silently drop rows
    (``ops.compact``), which is why — like the ``compact`` rule — no
    estimate is ever accepted."""
    preds: List[ir.Expr] = []
    node: ir.RelNode = f
    while isinstance(node, ir.Filter):
        preds.append(node.pred)
        node = node.child
    if not isinstance(node, ir.Scan):
        return None
    npt = catalog.np_tables.get(node.table)
    if not npt or catalog.stats[node.table].rows > COUNT_ROWS_CAP:
        return None
    cache = _count_cache(catalog)
    key = (node.table, tuple(ir._expr_sig(p) for p in preds))
    if key in cache:
        return cache[key]
    try:
        mask = np.ones(catalog.stats[node.table].rows, dtype=bool)
        for p in preds:
            m = np.asarray(evaluator.eval_expr(p, npt, registry, xp=np))
            if m.ndim == 2 and m.shape[1] == 1:
                m = m[:, 0]
            mask &= np.broadcast_to(m.astype(bool), mask.shape)
        count: Optional[int] = int(mask.sum())
    except Exception:
        count = None
    cache[key] = count
    return count


def sound_rows_bound(node: ir.RelNode, registry: Registry,
                     catalog: ir.Catalog) -> Optional[float]:
    """An upper bound on the live rows leaving ``node`` that is *sound* for
    the catalog's data (exact counts and monotone propagation only) — the
    legality test for compaction insertion, where a wrong estimate would
    drop rows rather than merely slow the query."""
    if isinstance(node, ir.Scan):
        return float(catalog.stats[node.table].rows)
    if isinstance(node, ir.Filter):
        b = sound_rows_bound(node.child, registry, catalog)
        cnt = _exact_chain_count(node, registry, catalog)
        if cnt is not None:
            return float(cnt) if b is None else min(b, float(cnt))
        # NO selectivity estimates/hints here: this bound sizes a Compact
        # capacity, where an optimistic guess drops rows instead of merely
        # slowing the query. A filter only removes rows, so the child
        # bound stays sound.
        return b
    if isinstance(node, ir.Compact):
        b = sound_rows_bound(node.child, registry, catalog)
        return float(node.capacity) if b is None else min(b, float(node.capacity))
    if isinstance(node, (ir.Project, ir.BlockedMatmul, ir.ForestRelational)):
        return sound_rows_bound(node.child, registry, catalog)
    if isinstance(node, ir.Join):  # FK join: right side unique on key
        return sound_rows_bound(node.left, registry, catalog)
    if isinstance(node, ir.CrossJoin):
        lb = sound_rows_bound(node.left, registry, catalog)
        rb = sound_rows_bound(node.right, registry, catalog)
        return None if lb is None or rb is None else lb * rb
    if isinstance(node, ir.Aggregate):
        b = sound_rows_bound(node.child, registry, catalog)
        g = float(node.num_groups)
        return g if b is None else min(b, g)
    raise TypeError(type(node))


# ---------------------------------------------------------------------------
# graph nodes + decision sites
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Site:
    """One lowering decision: a named, bounded option set. ``default`` is
    the tree-order / off / as-annotated option."""
    sid: str
    kind: str      # 'order' | 'compact' | 'realize' | 'part'
    options: tuple
    default: int = 0


class GNode:
    def children(self) -> Tuple["GNode", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class GScan(GNode):
    table: str


@dataclasses.dataclass(frozen=True)
class GPipeline(GNode):
    child: GNode
    vertices: Tuple[StageVertex, ...]
    order_sid: str
    # (site id, vertex index of the filter the optional compact glues to)
    compact_sids: Tuple[Tuple[str, int], ...]
    part_sid: Optional[str] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class GJoin(GNode):
    left: GNode
    right: GNode
    left_key: str
    right_key: str
    rprefix: str = ""
    part_sid: Optional[str] = None

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class GCrossJoin(GNode):
    left: GNode
    right: GNode
    aprefix: str = ""
    bprefix: str = ""
    part_sid: Optional[str] = None

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class GAggregate(GNode):
    child: GNode
    key: str
    aggs: tuple
    num_groups: int

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class GML(GNode):
    """BlockedMatmul / ForestRelational with an open realization choice."""
    child: GNode
    kind: str  # 'matmul' | 'forest'
    x_col: str
    out_col: str
    fn: str
    keep: Optional[Tuple[str, ...]]
    realize_sid: str
    part_sid: Optional[str] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class StageGraph:
    root: GNode
    registry: Registry
    sites: Dict[str, Site]
    ways: int = 1  # >1 iff partition sites were built (intra-query sharding)
    # catalog the graph was built against (scan capacities for partition
    # boundary sizing); realize() needs it only when partition sites exist
    catalog: Optional[ir.Catalog] = None

    # -- decisions ---------------------------------------------------------
    def default_decisions(self) -> Dict[str, int]:
        return {sid: s.default for sid, s in self.sites.items()}

    def partitioned_decisions(self) -> Dict[str, int]:
        """The maximally row-partitioned decision vector: every partition
        site takes its row-block option, everything else stays at the
        default. The coordinate-descent seed for memory-budgeted lowering —
        partitioning usually only fits the budget when *every* heavy node
        partitions, which no single-site flip from the default reaches."""
        d = self.default_decisions()
        for sid, s in self.sites.items():
            if s.kind == "part":
                d[sid] = 1  # options[1] is the row-block spec
        return d

    def decision_signature(self, decisions: Dict[str, int]) -> str:
        """Compact, stable realization-vector token (plan-cache key part)."""
        parts = []
        for sid in sorted(self.sites):
            site = self.sites[sid]
            opt = site.options[decisions[sid]]
            if site.kind == "order":
                parts.append(f"{sid}=" + "".join(str(i) for i in opt))
            elif site.kind == "compact":
                parts.append(f"{sid}={'-' if opt is None else opt}")
            else:
                parts.append(f"{sid}={opt.signature()}")
        return ";".join(parts)

    def n_candidates(self) -> int:
        n = 1
        for s in self.sites.values():
            n *= len(s.options)
        return n

    # -- realization -------------------------------------------------------
    def realize(self, decisions: Dict[str, int]) -> ph.PhysicalPlan:
        self._spec_of: Dict[int, ph.PartSpec] = {}
        root, spec, gcap, lcap = self._realize(self.root, decisions)
        if spec.kind != "rep":
            # the query result is a single table: always end replicated
            root = self._convert(root, spec, ph.REPLICATED, gcap, lcap)
        parts: Dict[str, ph.PartSpec] = {}

        def walk(n: ph.PhysNode, path: str) -> None:
            s = self._spec_of.get(id(n), ph.REPLICATED)
            if s.kind != "rep":
                parts[path] = s
            for i, c in enumerate(n.children()):
                walk(c, f"{path}.{i}")

        walk(root, "r")
        ways = self.ways if parts else 1
        return ph.PhysicalPlan(root=root, registry=self.registry,
                               parts=parts, ways=ways)

    def _part_spec(self, node, d: Dict[str, int]) -> ph.PartSpec:
        sid = getattr(node, "part_sid", None)
        if sid is None:
            return ph.REPLICATED
        return self.sites[sid].options[d[sid]]

    def _boundary(self, node: ph.PhysNode, op: str, ways: int,
                  in_cap: int, out_cap: int, key: Optional[str],
                  spec: ph.PartSpec) -> ph.PhysNode:
        b = ph.PRepartition(child=node, op=op, ways=ways,
                            in_capacity=in_cap, out_capacity=out_cap, key=key)
        self._spec_of[id(b)] = spec
        return b

    def _convert(self, node: ph.PhysNode, frm: ph.PartSpec, to: ph.PartSpec,
                 gcap: int, local_cap: Optional[int] = None) -> ph.PhysNode:
        """Insert the PRepartition boundary chain converting ``frm`` into
        ``to`` (normalizing through replicated). ``gcap`` is the global
        capacity at this point; ``local_cap`` the per-device capacity of a
        row-partitioned ``node`` (defaults to the padded block size)."""
        if frm == to:
            return node
        cur, spec = node, frm
        if spec.kind == "hash" and spec != to:
            cur = self._boundary(cur, "combine", spec.ways, gcap, gcap, None,
                                 ph.REPLICATED)
            spec = ph.REPLICATED
        if spec.kind == "row" and spec != to:
            from repro_torch.core import mesh as mesh_util
            local = (local_cap if local_cap is not None
                     else mesh_util.row_block(gcap, spec.ways))
            cur = self._boundary(cur, "allgather", spec.ways, local, gcap,
                                 None, ph.REPLICATED)
            spec = ph.REPLICATED
        if to.kind == "row":
            from repro_torch.core import mesh as mesh_util
            blk = mesh_util.row_block(gcap, to.ways)
            cur = self._boundary(cur, "slice", to.ways, gcap, blk, None, to)
        elif to.kind == "hash":
            cur = self._boundary(cur, "bucket", to.ways, gcap, gcap, to.key,
                                 to)
        return cur

    def _realize(self, node: GNode, d: Dict[str, int]
                 ) -> Tuple[ph.PhysNode, ph.PartSpec, int, int]:
        """Returns (physical node, its PartSpec, global capacity, local
        per-device capacity). Global and local agree except under a row
        partition, where local is this device's block."""
        out = self._realize_inner(node, d)
        self._spec_of[id(out[0])] = out[1]
        return out

    def _realize_inner(self, node: GNode, d: Dict[str, int]
                       ) -> Tuple[ph.PhysNode, ph.PartSpec, int, int]:
        if isinstance(node, GScan):
            cap = (self.catalog.stats[node.table].capacity
                   if self.catalog is not None else 0)
            return ph.PScan(table=node.table), ph.REPLICATED, cap, cap
        if isinstance(node, GPipeline):
            spec = self._part_spec(node, d)
            child, cspec, gcap, lcap = self._realize(node.child, d)
            order = self.sites[node.order_sid].options[d[node.order_sid]]
            glued = {}
            for sid, fidx in node.compact_sids:
                cap = self.sites[sid].options[d[sid]]
                if cap is not None:
                    glued[fidx] = cap
            stages: List[ph.Stage] = []
            for idx in order:
                stages.append(node.vertices[idx].stage)
                if idx in glued:
                    stages.append(ph.CompactStage(capacity=glued[idx]))
            compacts = [i for i, st in enumerate(stages)
                        if isinstance(st, ph.CompactStage)]
            if spec.kind == "row" and compacts:
                # a per-block compact would reorder rows against the global
                # compaction, so the prefix through the LAST compact runs
                # replicated and only the (row-local) suffix partitions —
                # which is also where the expensive per-row ML projects live
                from repro_torch.core import mesh as mesh_util
                child = self._convert(child, cspec, ph.REPLICATED, gcap,
                                      lcap)
                cut = compacts[-1] + 1
                pre = ph.PPipeline(child=child, stages=tuple(stages[:cut]))
                self._spec_of[id(pre)] = ph.REPLICATED
                for st in stages[:cut]:
                    if isinstance(st, ph.CompactStage):
                        gcap = st.capacity
                child = self._convert(pre, ph.REPLICATED, spec, gcap)
                return (ph.PPipeline(child=child, stages=tuple(stages[cut:])),
                        spec, gcap, mesh_util.row_block(gcap, spec.ways))
            child = self._convert(child, cspec, spec, gcap, lcap)
            if spec.kind == "row":
                from repro_torch.core import mesh as mesh_util
                lcap = mesh_util.row_block(gcap, spec.ways)
            else:
                lcap = gcap
            for st in stages:  # compacts only reach here replicated
                if isinstance(st, ph.CompactStage):
                    gcap = lcap = st.capacity
            return (ph.PPipeline(child=child, stages=tuple(stages)),
                    spec, gcap, lcap)
        if isinstance(node, GJoin):
            spec = self._part_spec(node, d)
            left, ls, lg, ll = self._realize(node.left, d)
            right, rs, rg, rr = self._realize(node.right, d)
            if spec.kind == "row":      # probe partitioned, build replicated
                from repro_torch.core import mesh as mesh_util
                left = self._convert(left, ls, spec, lg, ll)
                right = self._convert(right, rs, ph.REPLICATED, rg, rr)
                lloc = mesh_util.row_block(lg, spec.ways)
            elif spec.kind == "hash":   # both sides bucket-exchanged
                left = self._convert(
                    left, ls, dataclasses.replace(spec, key=node.left_key),
                    lg, ll)
                right = self._convert(
                    right, rs, dataclasses.replace(spec, key=node.right_key),
                    rg, rr)
                lloc = lg
            else:
                left = self._convert(left, ls, ph.REPLICATED, lg, ll)
                right = self._convert(right, rs, ph.REPLICATED, rg, rr)
                lloc = lg
            out_spec = (spec if spec.kind != "hash"
                        else dataclasses.replace(spec, key=node.left_key))
            return (ph.PJoin(left=left, right=right, left_key=node.left_key,
                             right_key=node.right_key, rprefix=node.rprefix),
                    out_spec, lg, lloc)
        if isinstance(node, GCrossJoin):
            spec = self._part_spec(node, d)
            left, ls, lg, ll = self._realize(node.left, d)
            right, rs, rg, rr = self._realize(node.right, d)
            right = self._convert(right, rs, ph.REPLICATED, rg, rr)
            if spec.kind == "row":      # left rows partitioned, right whole
                from repro_torch.core import mesh as mesh_util
                left = self._convert(left, ls, spec, lg, ll)
                lloc = mesh_util.row_block(lg, spec.ways) * rg
            else:
                left = self._convert(left, ls, ph.REPLICATED, lg, ll)
                lloc = lg * rg
            return (ph.PCrossJoin(left=left, right=right,
                                  aprefix=node.aprefix, bprefix=node.bprefix),
                    spec, lg * rg, lloc)
        if isinstance(node, GAggregate):
            child, cspec, gcap, lcap = self._realize(node.child, d)
            child = self._convert(child, cspec, ph.REPLICATED, gcap, lcap)
            return (ph.PAggregate(child=child, key=node.key, aggs=node.aggs,
                                  num_groups=node.num_groups),
                    ph.REPLICATED, node.num_groups, node.num_groups)
        if isinstance(node, GML):
            spec = self._part_spec(node, d)
            cfg = self.sites[node.realize_sid].options[d[node.realize_sid]]
            child, cspec, gcap, lcap = self._realize(node.child, d)
            child = self._convert(child, cspec, spec, gcap, lcap)
            if spec.kind == "row":
                from repro_torch.core import mesh as mesh_util
                lcap = mesh_util.row_block(gcap, spec.ways)
            else:
                lcap = gcap
            if node.kind == "matmul":
                pnode: ph.PhysNode = ph.PBlockedMatmul(
                    child=child, x_col=node.x_col, out_col=node.out_col,
                    fn=node.fn, n_tiles=cfg.n_tiles, mode=cfg.mode,
                    backend=cfg.backend, keep=node.keep)
            else:
                pnode = ph.PForestRelational(
                    child=child, x_col=node.x_col, out_col=node.out_col,
                    fn=node.fn, mode=cfg.mode, backend=cfg.backend,
                    keep=node.keep)
            return pnode, spec, gcap, lcap
        raise TypeError(type(node))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

class _Builder:
    def __init__(self, plan: ir.Plan, catalog: ir.Catalog,
                 backend: Optional[str], profile, ways: int = 1):
        self.plan = plan
        self.catalog = catalog
        self.backend = backend
        self.profile = profile
        self.ways = max(int(ways), 1)
        self.sites: Dict[str, Site] = {}
        self._n = 0

    def _sid(self, prefix: str) -> str:
        sid = f"{prefix}{self._n}"
        self._n += 1
        return sid

    def _part_site(self, *extra) -> Optional[str]:
        """A per-node PartSpec decision site: replicated (the default),
        row-block partitioned, plus any node-specific ``extra`` specs.
        Only built when lowering targets a multi-device mesh (ways > 1)."""
        if self.ways <= 1:
            return None
        opts = (ph.REPLICATED, ph.PartSpec(kind="row", ways=self.ways),
                *extra)
        sid = self._sid("pt")
        self.sites[sid] = Site(sid, "part", opts, 0)
        return sid

    def _realize_options(self, node) -> Tuple[ir.PhysConfig, ...]:
        cfg = self.plan.phys_for(node)  # resolves weight-derived n_tiles
        if self.backend is not None:
            be = PLAN_LEVEL_BACKENDS.get(self.backend, self.backend)
            return (ir.PhysConfig(mode=cfg.mode, backend=be,
                                  n_tiles=cfg.n_tiles),)
        if node.uid in (self.plan.phys or {}):
            # the optimizer chose explicitly (R3/R4-2); lowering does not
            # second-guess an annotation it cannot see the memory budget for
            return (cfg,)
        opts = [cfg]
        for mode in ("fused", "relational"):
            for be in (("torch", "kernel") if self.profile.supports_kernel
                       else ("torch",)):
                cand = ir.PhysConfig(mode=mode, backend=be,
                                     n_tiles=cfg.n_tiles)
                if cand != cfg:
                    opts.append(cand)
        return tuple(opts)

    def _pipeline(self, node: ir.RelNode) -> GPipeline:
        # maximal Filter/Project/Compact chain; stages run source-to-sink
        chain: List[ir.RelNode] = []
        cur = node
        while isinstance(cur, _ROW_LOCAL):
            chain.append(cur)
            cur = cur.children()[0]
        chain.reverse()  # source-to-sink
        vertices = tuple(_vertex(n) for n in chain)
        edges = _edges(vertices)

        # optional compaction after filters with a sound live-row bound
        compact_sids: List[Tuple[str, int]] = []
        for vi, (v, n) in enumerate(zip(vertices, chain)):
            if not v.is_filter:
                continue
            prev_compact = vi > 0 and vertices[vi - 1].is_compact
            next_compact = (vi + 1 < len(vertices)
                            and vertices[vi + 1].is_compact)
            if prev_compact or next_compact:  # don't stack compacts
                continue
            bound = sound_rows_bound(n, self.plan.registry, self.catalog)
            if bound is None:
                continue
            at_cap = ir.infer(n, self.plan.registry, self.catalog).capacity
            cap = compact_capacity(bound)
            # any real shrink is a candidate; the cost oracle arbitrates
            if cap < at_cap:
                sid = self._sid("c")
                self.sites[sid] = Site(sid, "compact", (None, cap), 0)
                compact_sids.append((sid, vi))

        # only enumerate orders when a compact (existing or insertable) can
        # actually move the capacity-driven cost
        has_compact = compact_sids or any(v.is_compact for v in vertices)
        orders = (_topo_orders(len(vertices), edges) if has_compact
                  else (tuple(range(len(vertices))),))
        osid = self._sid("p")
        self.sites[osid] = Site(osid, "order", orders, 0)
        return GPipeline(child=self.visit(cur), vertices=vertices,
                         order_sid=osid, compact_sids=tuple(compact_sids),
                         part_sid=self._part_site())

    def visit(self, node: ir.RelNode) -> GNode:
        if isinstance(node, _ROW_LOCAL):
            return self._pipeline(node)
        if isinstance(node, ir.Scan):
            return GScan(table=node.table)
        if isinstance(node, ir.Join):
            # row = probe (left) row-partitioned with the build side
            # replicated; hash = both sides bucket-exchanged on their keys
            return GJoin(left=self.visit(node.left),
                         right=self.visit(node.right),
                         left_key=node.left_key, right_key=node.right_key,
                         rprefix=node.rprefix,
                         part_sid=self._part_site(
                             ph.PartSpec(kind="hash", ways=self.ways,
                                         key=node.left_key)))
        if isinstance(node, ir.CrossJoin):
            return GCrossJoin(left=self.visit(node.left),
                              right=self.visit(node.right),
                              aprefix=node.aprefix, bprefix=node.bprefix,
                              part_sid=self._part_site())
        if isinstance(node, ir.Aggregate):
            return GAggregate(child=self.visit(node.child), key=node.key,
                              aggs=node.aggs, num_groups=node.num_groups)
        if isinstance(node, (ir.BlockedMatmul, ir.ForestRelational)):
            sid = self._sid("r")
            opts = self._realize_options(node)
            self.sites[sid] = Site(sid, "realize", opts, 0)
            return GML(child=self.visit(node.child),
                       kind=("matmul" if isinstance(node, ir.BlockedMatmul)
                             else "forest"),
                       x_col=node.x_col, out_col=node.out_col, fn=node.fn,
                       keep=node.keep, realize_sid=sid,
                       part_sid=self._part_site())
        raise TypeError(type(node))


def build(plan: ir.Plan, catalog: ir.Catalog, *,
          backend: Optional[str] = None, profile=None,
          ways: int = 1) -> StageGraph:
    """Stage-DAG of ``plan``'s lowering choices. ``backend`` force-overrides
    every realization's backend (plan-level realizations resolve per-node
    first); ``profile`` (default: that of the catalog's device) gates
    device-specific candidates (the kernels). ``ways > 1`` additionally
    opens per-node ``PartSpec`` sites (intra-query sharding over a
    ``ways``-rank data mesh)."""
    if profile is None:
        from repro_torch.core.cost import catalog_profile
        profile = catalog_profile(catalog)
    b = _Builder(plan, catalog, backend, profile, ways=ways)
    root = b.visit(plan.root)
    return StageGraph(root=root, registry=plan.registry, sites=b.sites,
                      ways=max(int(ways), 1), catalog=catalog)
