"""Analytic cost model: the single cost oracle of the stack.

Every component that needs a notion of "cheap" routes through ``plan_cost``:
the MCTS reward oracle (``planner.analytic_cost_fn`` / ``mcts.VanillaMCTS``),
costed lowering (``core.costed_lowering`` scores physical candidates), the
batched-dispatch estimate (``batched_plan_cost``), and calibration
(``fit_profile`` refits a ``DeviceProfile`` against measured dispatch
latencies). ``plan_cost`` accepts both the logical ``ir.Plan`` and the
physical ``physical.PhysicalPlan``; both walks share the same per-operator
``OpCost`` kernels, so there is exactly one set of cost formulas (a
tree-order-lowered physical plan costs bit-identically to its logical tree).

Costs each operator by FLOPs + bytes moved against a device profile, using
capacity (static shape) rather than live-row counts: every operator runs
over a table's full capacity, which is why compaction after selective
filters pays.

The formulas and the TPU, A100 and CPU priors are the JAX package's, number
for number, so both packages price a plan alike under one profile,
partition boundaries (``PRepartition``) included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.kernels.common import resolve_device
from repro_torch.mlfuncs.registry import Registry

PhysMap = Optional[Mapping[str, ir.PhysConfig]]


@dataclasses.dataclass
class DeviceProfile:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12      # bf16 FLOP/s
    hbm_bw: float = 819e9           # bytes/s
    vmem_bw: float = 4.0e12         # effective on-chip bandwidth for fused ops
    elem_bytes: int = 4
    # fixed overhead per relational operator (dispatch/fusion boundary)
    op_overhead_s: float = 2e-6
    # per-shard fan-in/out overhead of a multi-device (sharded) dispatch and
    # per-shard launch cost of one in-plan collective (allgather/psum).
    # Every prior is non-zero: a 0.0 default would price all collectives as
    # free and bias every sharded-vs-local decision toward sharding.
    collective_overhead_s: float = 1e-6
    # per-device working-set budget in bytes (None = unlimited): costed
    # lowering hard-rejects candidates whose phys_peak_memory exceeds it,
    # and plan_cost applies its paging penalty
    memory_budget: Optional[float] = None
    # whether the hand-written kernel realizations run on this device
    supports_kernel: bool = True

    def signature(self) -> str:
        """Calibratable-field token: anything calibration can move. Two
        profiles with equal signatures make identical lowering decisions."""
        mb = "-" if self.memory_budget is None else f"{self.memory_budget:.4e}"
        return (f"{self.name}:pf={self.peak_flops:.4e},bw={self.hbm_bw:.4e},"
                f"vb={self.vmem_bw:.4e},ov={self.op_overhead_s:.4e},"
                f"co={self.collective_overhead_s:.4e},mb={mb}")

    @classmethod
    def detect(cls, device=None) -> "DeviceProfile":
        """A fresh profile for the torch device a plan runs on: the H100
        prior on a CUDA card of compute capability 9.0, the A100 prior on
        any other CUDA card, the CPU prior on the CPU. ``None`` means the
        card, and raises without CUDA, like every entry point of the port.

        Returns a *copy* (profiles are mutable calibration targets; the
        module singletons below are priors, never calibrated in place).
        """
        dev = resolve_device(device)
        if dev.type == "cuda":
            prior = (H100_PROFILE if torch.cuda.get_device_capability(dev) == (9, 0)
                     else GPU_PROFILE)
        elif dev.type == "cpu":
            prior = CPU_PROFILE
        else:
            raise ValueError(f"no cost profile for device {dev}")
        return dataclasses.replace(prior)


# collective priors: per-shard launch latency of one ICI/NVLink collective
# on real accelerators; the "devices" of a forced CPU host mesh share one
# address space, so a collective there is a plain memcpy whose *volume*
# already rides data_bytes; only a tiny per-launch latency remains
TPU_PROFILE = DeviceProfile(collective_overhead_s=1e-6)

GPU_PROFILE = DeviceProfile(name="gpu-a100", peak_flops=312e12,
                            hbm_bw=1.55e12, vmem_bw=5.0e12,
                            op_overhead_s=3e-6, collective_overhead_s=2e-6,
                            supports_kernel=False)  # kernels are sm_90a only

CPU_PROFILE = DeviceProfile(name="cpu", peak_flops=2e11, hbm_bw=3e10,
                            vmem_bw=2e11, op_overhead_s=5e-6,
                            collective_overhead_s=2e-7,
                            supports_kernel=False)

H100_PROFILE = DeviceProfile(
    name="gpu-h100",
    peak_flops=989e12,   # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
    hbm_bw=3.35e12,      # HBM3 bytes/s, H100 SXM data sheet
    # shared memory: 132 SMs x 128 B a clock at clocks.max.sm 1980 MHz
    # (nvidia-smi on an H100 80GB HBM3 at 700 W, chip_smoke.py's [lower])
    vmem_bw=132 * 128 * 1980e6,
    # host time of one relational operator of the eager port (the unit
    # op_overhead_s prices: median over the 12 workloads at scale 0.05 of a
    # tree-order plan's wall time over its operator count), 389.37 us in
    # chip_smoke.py's [lower] line on an H100 80GB HBM3 at 700 W; one eager
    # torch operator alone took 8.37 us there
    op_overhead_s=3.9e-4,
    # no measurement: the card's multi-device runs share one H100 between
    # ranks over gloo, which says nothing of NVLink collectives; the A100
    # prior's value
    collective_overhead_s=2e-6,
    supports_kernel=True)

_DETECTED: Dict[str, DeviceProfile] = {}


def default_profile(device=None) -> DeviceProfile:
    """The detected profile of ``device``'s type (``None``: the card),
    computed once per device type. Default for every entry point that is
    handed neither a profile nor a catalog."""
    dev = resolve_device(device)
    if dev.type not in _DETECTED:
        _DETECTED[dev.type] = DeviceProfile.detect(dev)
    return _DETECTED[dev.type]


def catalog_device(catalog: ir.Catalog) -> torch.device:
    """The device the catalog's tables live on (the card if it has none)."""
    for t in catalog.tables.values():
        return t.device
    return resolve_device(None)


def catalog_profile(catalog: ir.Catalog) -> DeviceProfile:
    """``default_profile`` of the device the catalog's tables live on: the
    default of every entry point that is handed a catalog but no profile."""
    return default_profile(catalog_device(catalog))


# ---------------------------------------------------------------------------
# per-operator cost kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpCost:
    """One physical operator's resource footprint, device-independent.

    ``data_bytes`` scale with the data/batch axis (a B-query batched
    dispatch moves B x data_bytes); ``param_bytes`` are weight traffic,
    streamed once per dispatch and replicated across shards. ``n_ops``
    counts dispatch/fusion-boundary overhead units (``op_overhead_s``);
    ``n_coll`` counts per-shard collective launches
    (``collective_overhead_s`` — a ``ways``-way allgather/psum pays
    ``ways`` of them, its exchange volume rides ``data_bytes``).
    """
    label: str
    flops: float = 0.0
    data_bytes: float = 0.0
    param_bytes: float = 0.0
    bw: str = "hbm"              # 'hbm' | 'vmem' (kernel-fused operators)
    n_ops: int = 1
    n_coll: int = 0


def op_time(oc: OpCost, profile: DeviceProfile, data_scale: float = 1.0) -> float:
    """Roofline time of one operator: max(compute, traffic) + overhead."""
    bw = profile.vmem_bw if oc.bw == "vmem" else profile.hbm_bw
    return (max(oc.flops * data_scale / profile.peak_flops,
                (oc.data_bytes * data_scale + oc.param_bytes) / bw)
            + oc.n_ops * profile.op_overhead_s
            + oc.n_coll * profile.collective_overhead_s)


def _row_bytes(schema: Dict[str, int], profile: DeviceProfile) -> float:
    return sum(max(d, 1) for d in schema.values()) * profile.elem_bytes


def _filter_cost(pred_flops: float, schema, capacity, profile) -> OpCost:
    return OpCost("filter", flops=pred_flops * capacity,
                  data_bytes=_row_bytes(schema, profile) * capacity)


def _compact_cost(schema, cap_in, cap_out, profile) -> OpCost:
    return OpCost("compact", flops=cap_in * 8.0,  # sort + gather
                  data_bytes=_row_bytes(schema, profile) * (cap_in + cap_out))


def _project_cost(expr_flops: float, in_schema, out_schema, param_bytes,
                  capacity, profile) -> OpCost:
    by = (_row_bytes(in_schema, profile)
          + _row_bytes(out_schema, profile)) * capacity
    return OpCost("project", flops=expr_flops * capacity, data_bytes=by,
                  param_bytes=param_bytes)


def _join_cost(l_schema, l_cap, r_schema, r_cap, out_schema, out_cap,
               profile) -> OpCost:
    fl = (l_cap + r_cap) * 32.0  # sort/searchsorted
    by = (_row_bytes(l_schema, profile) * l_cap
          + _row_bytes(r_schema, profile) * r_cap
          + _row_bytes(out_schema, profile) * out_cap)
    return OpCost("join", flops=fl, data_bytes=by)


def _crossjoin_cost(out_schema, out_cap, profile) -> OpCost:
    return OpCost("crossjoin", flops=out_cap * 2.0,
                  data_bytes=2.0 * _row_bytes(out_schema, profile) * out_cap)


def _aggregate_cost(schema, capacity, n_aggs, profile) -> OpCost:
    return OpCost("aggregate", flops=capacity * (16.0 + 2.0 * n_aggs),
                  data_bytes=_row_bytes(schema, profile) * capacity)


def _matmul_cost(fn, x_dim, capacity, cfg: ir.PhysConfig, profile) -> OpCost:
    fl = fn.flops_per_row([x_dim]) * capacity
    pb = fn.param_bytes()
    xby = max(x_dim, 1) * profile.elem_bytes * capacity
    extra = 0
    if cfg.mode == "relational":
        # streamed tile scan: x re-read per tile + per-tile op overhead
        xby *= cfg.n_tiles
        extra = cfg.n_tiles
    return OpCost("matmul", flops=fl, data_bytes=2 * xby, param_bytes=pb,
                  bw="vmem" if cfg.backend == "kernel" else "hbm",
                  n_ops=1 + extra)


def _repartition_cost(node, schema, in_cap, profile) -> OpCost:
    """Partition-boundary cost: local copies for slice/bucket, exchange
    volume + per-shard collective launches for allgather/combine."""
    rb = _row_bytes(schema, profile)
    if node.op == "slice":
        return OpCost("repart_slice", data_bytes=2.0 * rb * node.out_capacity)
    if node.op == "allgather":
        # each device receives and writes the full reassembled table
        return OpCost("repart_allgather",
                      data_bytes=2.0 * rb * node.out_capacity,
                      n_coll=node.ways)
    if node.op == "bucket":
        # hash + compare on the key column, mask write
        return OpCost("repart_bucket", flops=4.0 * in_cap,
                      data_bytes=3.0 * profile.elem_bytes * in_cap)
    if node.op == "combine":
        # zero-and-psum of every column: full-table exchange per device
        return OpCost("repart_combine",
                      flops=float(max(len(schema), 1)) * in_cap,
                      data_bytes=2.0 * rb * node.out_capacity,
                      n_coll=node.ways)
    raise ValueError(f"unknown repartition op {node.op!r}")


def _forest_cost(fn, x_dim, capacity, cfg: ir.PhysConfig, profile) -> OpCost:
    fl = fn.flops_per_row([x_dim]) * capacity
    pb = fn.param_bytes()
    xby = max(x_dim, 1) * profile.elem_bytes * capacity
    if cfg.mode == "relational":
        p = fn.graph.nodes[0].atom.params
        xby *= p["feat"].shape[0]  # x re-read once per streamed tree
    return OpCost("forest", flops=fl, data_bytes=xby, param_bytes=pb,
                  bw="vmem" if cfg.backend == "kernel" else "hbm")


# ---------------------------------------------------------------------------
# logical-plan walk
# ---------------------------------------------------------------------------

def node_cost(node: ir.RelNode, registry: Registry, catalog: ir.Catalog,
              profile: DeviceProfile, phys: PhysMap = None) -> float:
    """Recursive total plan cost in seconds (analytic)."""
    total = sum(node_cost(c, registry, catalog, profile, phys)
                for c in node.children())
    oc = _node_op_cost(node, registry, catalog, profile, phys)
    if oc is not None:
        total += op_time(oc, profile)
    return total


def _node_op_cost(node: ir.RelNode, registry: Registry, catalog: ir.Catalog,
                  profile: DeviceProfile, phys: PhysMap = None
                  ) -> Optional[OpCost]:
    if isinstance(node, ir.Scan):
        return None
    if isinstance(node, ir.Filter):
        ci = ir.infer(node.child, registry, catalog)
        return _filter_cost(ir.expr_flops(node.pred, ci.schema, registry),
                            ci.schema, ci.capacity, profile)
    if isinstance(node, ir.Compact):
        ci = ir.infer(node.child, registry, catalog)
        return _compact_cost(ci.schema, ci.capacity, node.capacity, profile)
    if isinstance(node, ir.Project):
        ci = ir.infer(node.child, registry, catalog)
        fl = sum(ir.expr_flops(e, ci.schema, registry) for _, e in node.outputs)
        out = ir.infer(node, registry, catalog)
        # parameter traffic: weights stream from HBM once per call
        pb = 0.0
        for _, e in node.outputs:
            for c in _calls(e):
                pb += registry.get(c.fn).param_bytes()
        return _project_cost(fl, ci.schema, out.schema, pb, ci.capacity,
                             profile)
    if isinstance(node, ir.Join):
        li = ir.infer(node.left, registry, catalog)
        ri = ir.infer(node.right, registry, catalog)
        out = ir.infer(node, registry, catalog)
        return _join_cost(li.schema, li.capacity, ri.schema, ri.capacity,
                          out.schema, out.capacity, profile)
    if isinstance(node, ir.CrossJoin):
        out = ir.infer(node, registry, catalog)
        return _crossjoin_cost(out.schema, out.capacity, profile)
    if isinstance(node, ir.Aggregate):
        ci = ir.infer(node.child, registry, catalog)
        return _aggregate_cost(ci.schema, ci.capacity, len(node.aggs), profile)
    if isinstance(node, ir.BlockedMatmul):
        ci = ir.infer(node.child, registry, catalog)
        return _matmul_cost(registry.get(node.fn), ci.schema[node.x_col],
                            ci.capacity, ir.resolve_phys(node, phys, registry),
                            profile)
    if isinstance(node, ir.ForestRelational):
        ci = ir.infer(node.child, registry, catalog)
        return _forest_cost(registry.get(node.fn), ci.schema[node.x_col],
                            ci.capacity, ir.resolve_phys(node, phys, registry),
                            profile)
    raise TypeError(type(node))


def _calls(e: ir.Expr):
    if isinstance(e, ir.Call):
        yield e
    for c in e.children():
        yield from _calls(c)


# ---------------------------------------------------------------------------
# physical-plan walk (costed lowering's candidate scorer)
# ---------------------------------------------------------------------------

def _stage_info(stage, schema: Dict[str, int], capacity: int,
                registry: Registry) -> Tuple[Dict[str, int], int]:
    """Schema/capacity after one pipeline stage (exact, statically known)."""
    from repro_torch.core import physical as ph
    if isinstance(stage, ph.FilterStage):
        return schema, capacity
    if isinstance(stage, ph.CompactStage):
        return schema, stage.capacity
    if isinstance(stage, ph.ProjectStage):
        out = (dict(schema) if stage.keep is None
               else {k: schema[k] for k in stage.keep})
        for name, e in stage.outputs:
            out[name] = ir.expr_dim(e, schema, registry)
        return out, capacity
    raise TypeError(type(stage))


def _derive_info(node, registry: Registry, catalog: ir.Catalog,
                 child_infos) -> Tuple[Dict[str, int], int]:
    """(schema, capacity) of a physical node's output from its children's
    already-computed infos — single level, so walks that visit each node
    once stay linear in plan size."""
    from repro_torch.core import physical as ph
    if isinstance(node, ph.PScan):
        st = catalog.stats[node.table]
        return {c: s.dim for c, s in st.columns.items()}, st.capacity
    if isinstance(node, ph.PPipeline):
        schema, cap = child_infos[0]
        for stage in node.stages:
            schema, cap = _stage_info(stage, schema, cap, registry)
        return schema, cap
    if isinstance(node, ph.PJoin):
        (ls, lc), (rs, _) = child_infos
        schema = dict(ls)
        for c, d in rs.items():
            out = node.rprefix + c
            if out == node.left_key and c == node.right_key:
                continue
            schema[out] = d
        return schema, lc
    if isinstance(node, ph.PCrossJoin):
        (ls, lc), (rs, rc) = child_infos
        schema = {node.aprefix + c: d for c, d in ls.items()}
        schema.update({node.bprefix + c: d for c, d in rs.items()})
        return schema, lc * rc
    if isinstance(node, ph.PAggregate):
        cs, _ = child_infos[0]
        schema = {node.key: 0}
        for out, (kind, in_col) in node.aggs:
            schema[out] = 0 if kind == "count" else cs.get(in_col, 0)
        return schema, node.num_groups
    if isinstance(node, ph.PBlockedMatmul):
        cs, cc = child_infos[0]
        schema = dict(cs) if node.keep is None else {k: cs[k] for k in node.keep}
        schema[node.out_col] = registry.get(node.fn).out_dim([cs[node.x_col]])
        return schema, cc
    if isinstance(node, ph.PForestRelational):
        cs, cc = child_infos[0]
        schema = dict(cs) if node.keep is None else {k: cs[k] for k in node.keep}
        schema[node.out_col] = 0
        return schema, cc
    if isinstance(node, ph.PRepartition):
        cs, cc = child_infos[0]
        if node.op in ("slice", "allgather"):
            # the walk downstream of a slice sees the per-device block
            # capacity, which is what makes the physical walk price (and
            # phys_peak_memory bound) *per-device* work on partitioned plans
            return cs, node.out_capacity
        return cs, cc  # bucket/combine: capacity unchanged
    raise TypeError(type(node))


def phys_node_info(node, registry: Registry, catalog: ir.Catalog
                   ) -> Tuple[Dict[str, int], int]:
    """(schema, capacity) of a physical node's output — the physical mirror
    of ``ir.infer`` without row estimates (cost is capacity-driven)."""
    return _derive_info(node, registry, catalog,
                        tuple(phys_node_info(c, registry, catalog)
                              for c in node.children()))


def phys_op_costs(pplan, catalog: ir.Catalog,
                  profile: DeviceProfile) -> List[OpCost]:
    """Per-operator OpCosts of a physical plan, through the same kernels as
    the logical walk (tree-order lowering costs identically either way)."""
    from repro_torch.core import physical as ph
    registry = pplan.registry
    out: List[OpCost] = []

    def visit(node) -> Tuple[Dict[str, int], int]:
        child_infos = tuple(visit(c) for c in node.children())
        if isinstance(node, ph.PPipeline):
            schema, cap = child_infos[0]
            for stage in node.stages:
                nxt = _stage_info(stage, schema, cap, registry)
                if isinstance(stage, ph.FilterStage):
                    out.append(_filter_cost(
                        ir.expr_flops(stage.pred, schema, registry),
                        schema, cap, profile))
                elif isinstance(stage, ph.CompactStage):
                    out.append(_compact_cost(schema, cap, stage.capacity,
                                             profile))
                elif isinstance(stage, ph.ProjectStage):
                    fl = sum(ir.expr_flops(e, schema, registry)
                             for _, e in stage.outputs)
                    pb = 0.0
                    for _, e in stage.outputs:
                        for c in _calls(e):
                            pb += registry.get(c.fn).param_bytes()
                    out.append(_project_cost(fl, schema, nxt[0], pb, cap,
                                             profile))
                schema, cap = nxt
            return schema, cap
        info = _derive_info(node, registry, catalog, child_infos)
        if isinstance(node, ph.PJoin):
            (ls, lc), (rs, rc) = child_infos
            out.append(_join_cost(ls, lc, rs, rc, info[0], info[1], profile))
        elif isinstance(node, ph.PCrossJoin):
            out.append(_crossjoin_cost(info[0], info[1], profile))
        elif isinstance(node, ph.PAggregate):
            cs, cc = child_infos[0]
            out.append(_aggregate_cost(cs, cc, len(node.aggs), profile))
        elif isinstance(node, ph.PBlockedMatmul):
            cs, cc = child_infos[0]
            cfg = ir.PhysConfig(mode=node.mode, backend=node.backend,
                                n_tiles=node.n_tiles)
            out.append(_matmul_cost(registry.get(node.fn), cs[node.x_col],
                                    cc, cfg, profile))
        elif isinstance(node, ph.PForestRelational):
            cs, cc = child_infos[0]
            cfg = ir.PhysConfig(mode=node.mode, backend=node.backend)
            out.append(_forest_cost(registry.get(node.fn), cs[node.x_col],
                                    cc, cfg, profile))
        elif isinstance(node, ph.PRepartition):
            cs, cc = child_infos[0]
            out.append(_repartition_cost(node, cs, cc, profile))
        elif not isinstance(node, ph.PScan):
            raise TypeError(type(node))
        return info

    visit(pplan.root)
    return out


def phys_peak_memory(pplan, catalog: ir.Catalog,
                     profile: DeviceProfile) -> float:
    """Peak working set of a physical plan (max across operators), the
    physical mirror of ``node_mem``."""
    from repro_torch.core import physical as ph
    registry = pplan.registry
    peak = 0.0

    def base(schema, cap) -> float:
        return _row_bytes(schema, profile) * cap

    def visit(node) -> Tuple[Dict[str, int], int]:
        nonlocal peak
        child_infos = tuple(visit(c) for c in node.children())
        if isinstance(node, ph.PScan):
            schema, cap = _derive_info(node, registry, catalog, child_infos)
            peak = max(peak, base(schema, cap))
            return schema, cap
        if isinstance(node, ph.PPipeline):
            schema, cap = child_infos[0]
            for stage in node.stages:
                schema, cap = _stage_info(stage, schema, cap, registry)
                m = base(schema, cap)
                if isinstance(stage, ph.ProjectStage):
                    for _, e in stage.outputs:
                        for c in _calls(e):
                            m += registry.get(c.fn).param_bytes()
                peak = max(peak, m)
            return schema, cap
        schema, cap = _derive_info(node, registry, catalog, child_infos)
        m = base(schema, cap)
        if isinstance(node, ph.PBlockedMatmul):
            fn = registry.get(node.fn)
            # streamed: only one weight tile resident at a time
            m += fn.param_bytes() / max(node.n_tiles, 1)
        elif isinstance(node, ph.PForestRelational):
            fn = registry.get(node.fn)
            p = fn.graph.nodes[0].atom.params
            m += fn.param_bytes() / max(int(p["feat"].shape[0]), 1)
        elif isinstance(node, ph.PRepartition) and node.op == "allgather":
            # the gather target holds the padded concatenation of every
            # device's block (in_capacity = per-device block) briefly
            m = base(schema, node.in_capacity * node.ways)
        peak = max(peak, m)
        return schema, cap

    visit(pplan.root)
    return peak


# ---------------------------------------------------------------------------
# memory (peak working set) — the paper's OOM axis (Table I, Fig. 6)
# ---------------------------------------------------------------------------

def node_mem(node: ir.RelNode, registry: Registry, catalog: ir.Catalog,
             profile: DeviceProfile, phys: PhysMap = None) -> float:
    """Peak bytes over the plan (max across operators)."""
    peak = max((node_mem(c, registry, catalog, profile, phys)
                for c in node.children()), default=0.0)
    return max(peak, _local_mem(node, registry, catalog, profile, phys))


def _local_mem(node, registry, catalog, profile, phys=None):
    if isinstance(node, ir.Scan):
        st = catalog.stats[node.table]
        return _row_bytes({c: s.dim for c, s in st.columns.items()}, profile) * st.capacity
    out = ir.infer(node, registry, catalog)
    base = _row_bytes(out.schema, profile) * out.capacity
    if isinstance(node, ir.Project):
        pb = 0.0
        for _, e in node.outputs:
            for c in _calls(e):
                pb += registry.get(c.fn).param_bytes()
        return base + pb
    if isinstance(node, ir.BlockedMatmul):
        fn = registry.get(node.fn)
        # streamed: only one weight tile resident at a time
        return base + fn.param_bytes() / max(ir.resolve_phys(node, phys, registry).n_tiles, 1)
    if isinstance(node, ir.ForestRelational):
        fn = registry.get(node.fn)
        p = fn.graph.nodes[0].atom.params
        n_trees = max(int(p["feat"].shape[0]), 1)  # per-tree streaming
        return base + fn.param_bytes() / n_trees
    return base


def plan_peak_memory(plan, catalog: ir.Catalog,
                     profile: DeviceProfile | None = None) -> float:
    from repro_torch.core import physical as ph
    profile = profile or catalog_profile(catalog)
    if isinstance(plan, ph.PhysicalPlan):
        return phys_peak_memory(plan, catalog, profile)
    return node_mem(plan.root, plan.registry, catalog, profile, plan.phys)


# ---------------------------------------------------------------------------
# the single entry point
# ---------------------------------------------------------------------------

def plan_cost(plan, catalog: ir.Catalog,
              profile: DeviceProfile | None = None,
              memory_budget: float | None = None) -> float:
    """Analytic plan latency — logical ``ir.Plan`` or physical
    ``PhysicalPlan`` alike; plans whose working set exceeds the memory
    budget pay a paging/OOM penalty (mirrors the paper's OOM failures).
    ``memory_budget`` defaults to the profile's own per-device budget; a
    non-finite budget is explicitly unlimited (callers that already
    checked the peak themselves — costed lowering's hard gate — pass
    ``inf`` to skip the redundant peak walk)."""
    from repro_torch.core import physical as ph
    profile = profile or catalog_profile(catalog)
    if memory_budget is None:
        memory_budget = profile.memory_budget
    if isinstance(plan, ph.PhysicalPlan):
        t = sum(op_time(oc, profile)
                for oc in phys_op_costs(plan, catalog, profile))
    else:
        t = node_cost(plan.root, plan.registry, catalog, profile, plan.phys)
    if memory_budget is not None and np.isfinite(memory_budget):
        peak = plan_peak_memory(plan, catalog, profile)
        if peak > memory_budget:
            t *= 1.0 + 20.0 * (peak / memory_budget - 1.0)
    return t


@dataclasses.dataclass
class CostBreakdown:
    """Profile-independent resource totals of one plan (plus the seconds the
    given profile predicts) — the calibration features of ``fit_profile``.
    ``hbm_bytes`` are per-query data traffic (they scale with batch
    occupancy); ``param_bytes`` stream once per dispatch. ``n_coll``
    counts per-shard collective launches (in-plan repartition boundaries
    and/or the sharded dispatch's fan-in/out) — the calibration feature of
    ``collective_overhead_s``."""
    flops: float
    hbm_bytes: float
    param_bytes: float
    vmem_bytes: float
    n_ops: int
    seconds: float
    n_coll: float = 0.0

    def scaled(self, occupancy: float) -> "CostBreakdown":
        """The breakdown of one ``occupancy``-query micro-batched dispatch:
        data traffic and FLOPs scale, weights and op count do not."""
        return dataclasses.replace(self, flops=self.flops * occupancy,
                                   hbm_bytes=self.hbm_bytes * occupancy,
                                   vmem_bytes=self.vmem_bytes * occupancy)


def plan_cost_breakdown(plan, catalog: ir.Catalog,
                        profile: DeviceProfile | None = None) -> CostBreakdown:
    from repro_torch.core import physical as ph
    profile = profile or catalog_profile(catalog)
    if isinstance(plan, ph.PhysicalPlan):
        ocs = phys_op_costs(plan, catalog, profile)
    else:
        ocs = [oc for oc in
               (_node_op_cost(n, plan.registry, catalog, profile, plan.phys)
                for n in ir.walk(plan.root)) if oc is not None]
    return CostBreakdown(
        flops=sum(oc.flops for oc in ocs),
        hbm_bytes=sum(oc.data_bytes for oc in ocs if oc.bw == "hbm"),
        param_bytes=sum(oc.param_bytes for oc in ocs if oc.bw == "hbm"),
        vmem_bytes=sum(oc.data_bytes + oc.param_bytes for oc in ocs
                       if oc.bw == "vmem"),
        n_ops=sum(oc.n_ops for oc in ocs),
        seconds=sum(op_time(oc, profile) for oc in ocs),
        n_coll=float(sum(oc.n_coll for oc in ocs)))


def batched_plan_cost(plan, catalog: ir.Catalog, batch_size: int,
                      profile: DeviceProfile | None = None,
                      ways: int = 1) -> float:
    """Predicted latency of one micro-batched dispatch of ``batch_size``
    same-signature queries: data traffic and FLOPs scale with the per-shard
    slice (``batch_size / ways``), weights are replicated (streamed once per
    shard), and a ``ways``-way sharded dispatch pays the profile's collective
    overhead per shard. ``ways=1`` is the single-device realization;
    the serving tier's batched-vs-sharded choice compares the two
    (``costed_lowering.choose_batch_realization``)."""
    from repro_torch.core import physical as ph
    profile = profile or catalog_profile(catalog)
    if isinstance(plan, ph.PhysicalPlan):
        ocs = phys_op_costs(plan, catalog, profile)
    else:
        ocs = [oc for oc in
               (_node_op_cost(n, plan.registry, catalog, profile, plan.phys)
                for n in ir.walk(plan.root)) if oc is not None]
    scale = batch_size / max(ways, 1)
    t = sum(op_time(oc, profile, data_scale=scale) for oc in ocs)
    if ways > 1:
        t += ways * profile.collective_overhead_s
    return t


# ---------------------------------------------------------------------------
# online calibration: measured latencies -> refitted profile
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibrationFit:
    profile: DeviceProfile
    n_samples: int
    mape_before: float
    mape_after: float


def _mape(pred: np.ndarray, actual: np.ndarray) -> float:
    actual = np.maximum(actual, 1e-12)
    return float(np.mean(np.abs(pred - actual) / actual))


def fit_profile(samples: Sequence[Tuple[CostBreakdown, float, float]],
                prior: DeviceProfile, l2: float = 0.1,
                max_shift: float = 100.0) -> CalibrationFit:
    """Least-squares refit of (peak_flops, hbm_bw, op_overhead_s,
    collective_overhead_s) from measured latencies.

    ``samples`` are ``(breakdown, measured_seconds, weight)`` triples; the
    linearized prediction ``flops/peak + bytes/bw + n_ops*overhead +
    n_coll*coll_overhead`` is fit in the coefficient space ``x = (1/peak,
    1/bw, overhead, coll_overhead)``. The loss is the weighted *relative*
    squared error (a 200us dispatch mispredicted 2x matters as much as a
    200ms one) plus a log-space ridge toward the prior — multiplicative
    shifts are what calibration corrects, so the penalty is symmetric in
    them, and under-determined directions (measured traffic rarely spans
    enough signatures to identify every coefficient; purely single-device
    traffic has an all-zero ``n_coll`` column) stay at the prior.
    Coefficients live in ``[prior/max_shift, prior*max_shift]`` so a
    pathological batch of measurements cannot turn the oracle nonsensical;
    a coefficient whose prior is zero is pinned (the log-space ridge has no
    anchor there). Solved by deterministic per-coordinate search over a
    refined log grid (4 coefficients; no solver dependency).
    """
    if not samples:
        return CalibrationFit(dataclasses.replace(prior), 0, 0.0, 0.0)
    A = np.array([[b.flops, b.hbm_bytes + b.param_bytes, float(b.n_ops),
                   float(b.n_coll)]
                  for b, _, _ in samples], dtype=np.float64)
    t = np.array([max(m, 1e-9) for _, m, _ in samples], dtype=np.float64)
    w = np.array([max(wt, 1e-12) for _, _, wt in samples], dtype=np.float64)
    x0 = np.array([1.0 / prior.peak_flops, 1.0 / prior.hbm_bw,
                   prior.op_overhead_s, prior.collective_overhead_s],
                  dtype=np.float64)
    active = [k for k in range(4) if x0[k] > 0]
    pred_before = A @ x0
    lo, hi = x0 / max_shift, x0 * max_shift
    w_total = float(np.sum(w))
    log_shift = np.log(max_shift)

    def objective(x: np.ndarray) -> float:
        rel = (A @ x - t) / t
        ridge = float(sum((np.log(x[k] / x0[k]) / log_shift) ** 2
                          for k in active))
        return float(np.sum(w * rel ** 2)) + l2 * w_total * ridge

    x = x0.copy()
    for _ in range(24):
        x_prev = x.copy()
        for k in active:
            span_lo, span_hi = np.log(lo[k]), np.log(hi[k])
            for _refine in range(3):
                grid = np.exp(np.linspace(span_lo, span_hi, 33))
                scores = []
                for g in grid:
                    xk = x.copy()
                    xk[k] = g
                    scores.append(objective(xk))
                bi = int(np.argmin(scores))
                x[k] = grid[bi]
                span_lo = np.log(grid[max(bi - 1, 0)])
                span_hi = np.log(grid[min(bi + 1, len(grid) - 1)])
        if np.max(np.abs(np.log(np.maximum(x, 1e-300)
                                / np.maximum(x_prev, 1e-300)))) < 1e-6:
            break
    fitted = dataclasses.replace(
        prior,
        peak_flops=1.0 / x[0],
        hbm_bw=1.0 / x[1],
        op_overhead_s=float(x[2]),
        collective_overhead_s=float(x[3]),
        name=prior.name if prior.name.endswith("+cal") else prior.name + "+cal")
    return CalibrationFit(profile=fitted, n_samples=len(samples),
                          mape_before=_mape(pred_before, t),
                          mape_after=_mape(A @ x, t))
