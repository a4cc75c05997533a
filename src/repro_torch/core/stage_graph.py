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

The partitioning sites of intra-query sharding (``ways > 1``: per-node
``PartSpec`` candidates and ``PRepartition`` boundaries) belong to the
multi-device path, which the port does not have yet (ROADMAP.md, queue 1
item 12); ``build`` refuses ``ways > 1``.

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
    kind: str      # 'order' | 'compact' | 'realize'
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

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class GJoin(GNode):
    left: GNode
    right: GNode
    left_key: str
    right_key: str
    rprefix: str = ""

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class GCrossJoin(GNode):
    left: GNode
    right: GNode
    aprefix: str = ""
    bprefix: str = ""

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

    def children(self):
        return (self.child,)


@dataclasses.dataclass
class StageGraph:
    root: GNode
    registry: Registry
    sites: Dict[str, Site]

    # -- decisions ---------------------------------------------------------
    def default_decisions(self) -> Dict[str, int]:
        return {sid: s.default for sid, s in self.sites.items()}

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
        return ph.PhysicalPlan(root=self._realize(self.root, decisions),
                               registry=self.registry)

    def _realize(self, node: GNode, d: Dict[str, int]) -> ph.PhysNode:
        if isinstance(node, GScan):
            return ph.PScan(table=node.table)
        if isinstance(node, GPipeline):
            child = self._realize(node.child, d)
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
            return ph.PPipeline(child=child, stages=tuple(stages))
        if isinstance(node, GJoin):
            return ph.PJoin(left=self._realize(node.left, d),
                            right=self._realize(node.right, d),
                            left_key=node.left_key, right_key=node.right_key,
                            rprefix=node.rprefix)
        if isinstance(node, GCrossJoin):
            return ph.PCrossJoin(left=self._realize(node.left, d),
                                 right=self._realize(node.right, d),
                                 aprefix=node.aprefix, bprefix=node.bprefix)
        if isinstance(node, GAggregate):
            return ph.PAggregate(child=self._realize(node.child, d),
                                 key=node.key, aggs=node.aggs,
                                 num_groups=node.num_groups)
        if isinstance(node, GML):
            cfg = self.sites[node.realize_sid].options[d[node.realize_sid]]
            child = self._realize(node.child, d)
            if node.kind == "matmul":
                return ph.PBlockedMatmul(
                    child=child, x_col=node.x_col, out_col=node.out_col,
                    fn=node.fn, n_tiles=cfg.n_tiles, mode=cfg.mode,
                    backend=cfg.backend, keep=node.keep)
            return ph.PForestRelational(
                child=child, x_col=node.x_col, out_col=node.out_col,
                fn=node.fn, mode=cfg.mode, backend=cfg.backend,
                keep=node.keep)
        raise TypeError(type(node))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

class _Builder:
    def __init__(self, plan: ir.Plan, catalog: ir.Catalog,
                 backend: Optional[str], profile):
        self.plan = plan
        self.catalog = catalog
        self.backend = backend
        self.profile = profile
        self.sites: Dict[str, Site] = {}
        self._n = 0

    def _sid(self, prefix: str) -> str:
        sid = f"{prefix}{self._n}"
        self._n += 1
        return sid

    def _realize_options(self, node) -> Tuple[ir.PhysConfig, ...]:
        cfg = self.plan.phys_for(node)  # resolves weight-derived n_tiles
        if self.backend is not None:
            return (ir.PhysConfig(mode=cfg.mode, backend=self.backend,
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
                         order_sid=osid, compact_sids=tuple(compact_sids))

    def visit(self, node: ir.RelNode) -> GNode:
        if isinstance(node, _ROW_LOCAL):
            return self._pipeline(node)
        if isinstance(node, ir.Scan):
            return GScan(table=node.table)
        if isinstance(node, ir.Join):
            return GJoin(left=self.visit(node.left),
                         right=self.visit(node.right),
                         left_key=node.left_key, right_key=node.right_key,
                         rprefix=node.rprefix)
        if isinstance(node, ir.CrossJoin):
            return GCrossJoin(left=self.visit(node.left),
                              right=self.visit(node.right),
                              aprefix=node.aprefix, bprefix=node.bprefix)
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
                       keep=node.keep, realize_sid=sid)
        raise TypeError(type(node))


def build(plan: ir.Plan, catalog: ir.Catalog, *,
          backend: Optional[str] = None, profile=None,
          ways: int = 1) -> StageGraph:
    """Stage-DAG of ``plan``'s lowering choices. ``backend`` force-overrides
    every realization's backend; ``profile`` (default: that of the
    catalog's device) gates device-specific candidates (the kernels).
    ``ways > 1``, intra-query sharding over a multi-device mesh, is not
    ported yet (ROADMAP.md, queue 1 item 12)."""
    if ways > 1:
        raise NotImplementedError(
            "partitioned lowering (ways > 1) is not ported yet "
            "(ROADMAP.md, queue 1 item 12)")
    if profile is None:
        from repro_torch.core.cost import catalog_profile
        profile = catalog_profile(catalog)
    b = _Builder(plan, catalog, backend, profile)
    root = b.visit(plan.root)
    return StageGraph(root=root, registry=plan.registry, sites=b.sites)
