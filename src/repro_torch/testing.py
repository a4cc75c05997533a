"""Comparison helpers shared by the parity tests and ``chip_smoke.py``, and
the multi-rank runs of the mesh paths.

``spawn_ranks(body, ways)`` runs ``body(rank, ways, *args)`` on ``ways``
processes joined in one gloo group (spawned, one intra-op thread each, a
``FileStore`` in a temporary directory, the group's ``timeout``); a
failure of any rank raises in the caller. The rank bodies of the CPU proof
live here too (``partitioned_suite`` and ``sharded_suite``, the
counterparts of the JAX package's ``tests/partitioned_equality_driver.py``
and ``tests/sharded_equality_driver.py`` plus the multi-device checks of
``tests/test_partitioned.py`` and ``tests/test_serving_sharded.py``, and
``fault_suite``, where one rank's bad payload must fail the run), so that
the ranks import neither JAX nor the test modules:

    PYTHONPATH=src python -m repro_torch.testing partitioned --ways 8 --out DIR

Rank 0 prints an ``... OK`` line per check and writes the canonical results
the parent holds against the JAX reference to ``DIR``.
"""
from __future__ import annotations

import argparse
import datetime
import sys
import tempfile
from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np

WORKLOAD_TOL = 5e-4  # .canonical() bar of the JAX package's workload tests
PARTITION_TOL = 2e-5  # floats of a multi-rank run against one device
GROUP_TIMEOUT_S = 120.0  # a rank that never joins a collective fails the rest
MESH_SCALE = 0.25  # the reference drivers' SCALE
MESH_BATCH = 8  # the sharded driver's BATCH


def assert_canonical_close(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray],
                           label: str = "", tol: float = WORKLOAD_TOL) -> None:
    """Two ``Table.canonical()`` dicts agree: same columns and row count,
    integer and bool columns exactly, float columns at rtol=atol=``tol``."""
    if set(a) != set(b):
        raise AssertionError(f"{label}: schemas differ {sorted(set(a) ^ set(b))}")
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape:
            raise AssertionError(f"{label}:{k}: shapes {x.shape} vs {y.shape}")
        if x.dtype.kind in "biu" and y.dtype.kind in "biu":
            np.testing.assert_array_equal(x, y, err_msg=f"{label}:{k}")
        else:
            np.testing.assert_allclose(x, y, rtol=tol, atol=tol, err_msg=f"{label}:{k}")


def assert_tables_equal(want, got, label: str, tol: float = PARTITION_TOL) -> None:
    """Two result Tables row for row: valid masks and int columns exactly,
    float columns at rtol=atol=``tol`` on the valid rows (invalid rows carry
    garbage), and the canonical forms alike."""
    if set(want.columns) != set(got.columns):
        raise AssertionError(f"{label}: schemas differ")
    m = want.valid.cpu().numpy()
    np.testing.assert_array_equal(m, got.valid.cpu().numpy(), err_msg=f"{label}.valid")
    for k in want.columns:
        a, b = want[k].cpu().numpy()[m], got[k].cpu().numpy()[m]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{label}.{k}")
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{label}.{k}")
    assert_canonical_close(want.canonical(), got.canonical(), label, tol)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, body: Callable, ways: int, store: str, device: str,
               timeout_s: float, args: tuple) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", store=dist.FileStore(store, ways), rank=rank,
                            world_size=ways,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        body(rank, ways, *args)
    except BaseException:
        # the parent reports only the first rank it sees fail, often one that
        # lost a peer; each rank's own traceback goes to standard error
        import traceback
        print(f"rank {rank} raised:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(body: Callable, ways: int, *, args: tuple = (), device: str = "cpu",
                timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Run ``body(rank, ways, *args)`` on ``ways`` spawned processes in one
    gloo group on ``device`` (``cpu`` or ``cuda:0``: gloo lets several
    ranks share one card, NCCL does not). ``body`` must be importable by
    name (a module-level function). Returns when every rank has; raises
    if any rank raised, after stopping the others."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, nprocs=ways, join=True, start_method="spawn",
                           args=(body, ways, str(Path(tmp) / "store"), device,
                                 timeout_s, args))


def say(rank: int, line: str) -> None:
    """Print ``line`` from rank 0 only."""
    if rank == 0:
        print(line, flush=True)


def _save(out_dir: Optional[str], rank: int, label: str, table) -> None:
    if out_dir is not None and rank == 0:
        np.savez(Path(out_dir) / f"{label}.npz", **table.canonical())


def load_canonical(out_dir, label: str) -> dict:
    """A canonical result rank 0 saved under ``label``."""
    with np.load(Path(out_dir) / f"{label}.npz") as z:
        return {k: z[k] for k in z.files}


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


# ---------------------------------------------------------------------------
# the partitioned (PartSpec) suite
# ---------------------------------------------------------------------------

def partition_flavours(graph, base: Optional[dict] = None) -> dict:
    """The partitioned decision vectors of a stage graph built with
    ``ways > 1``, on top of ``base`` (default: the default decisions):
    'row' (every partition site row-blocked) and, where a join offers it,
    'hash' (joins hash-bucketed, the rest row-blocked)."""
    sites = [s for s in graph.sites.values() if s.kind == "part"]
    if not sites:
        raise AssertionError("no partition sites")
    base = dict(base if base is not None else graph.default_decisions())
    flavours = {"row": dict(base, **{s.sid: 1 for s in sites})}
    if any(len(s.options) > 2 for s in sites):
        flavours["hash"] = dict(base, **{s.sid: len(s.options) - 1 for s in sites})
    return flavours


def replicated(graph, decisions: dict) -> dict:
    """``decisions`` with every partition site replicated: the same
    realization on one device."""
    return {sid: (0 if graph.sites[sid].kind == "part" else i)
            for sid, i in decisions.items()}


def run_partitioned(pplan, tables: dict, mesh):
    from repro_torch.core import mesh as mesh_util
    from repro_torch.core import physical as ph
    return mesh_util.shard_replicated(
        lambda t: ph.run(pplan, t, mesh, mesh_util.DATA_AXIS), mesh)(tables)


def _check_workload(name, mesh, ways, rank, out_dir):
    from repro_torch.core import cost, physical as ph, stage_graph
    from repro_torch.data import workloads
    w = workloads.ALL_WORKLOADS[name](scale=MESH_SCALE, device="cpu")
    g = stage_graph.build(w.plan, w.catalog, profile=cost.DeviceProfile.detect("cpu"),
                          ways=ways)
    for flavour, d in partition_flavours(g).items():
        pplan = g.realize(d)
        assert pplan.ways == ways and pplan.parts, (name, flavour)
        want = ph.run(g.realize(replicated(g, d)), dict(w.catalog.tables))
        got = run_partitioned(pplan, dict(w.catalog.tables), mesh)
        assert_tables_equal(want, got, f"{name}/{flavour}")
        _save(out_dir, rank, f"{name}.{flavour}", got)
        say(rank, f"{name}/{flavour}: OK")


def _check_r3(mesh, ways, rank, out_dir):
    """Row-partitioned PBlockedMatmul / PForestRelational (the R3 rewrites'
    realizations) equal one device."""
    from repro_torch.core import cost, physical as ph, stage_graph
    from repro_torch.core.rules import ALL_RULES
    from repro_torch.data import workloads
    for name, rule in (("rec_q3", "R3-1"), ("analytics_q1", "R3-2")):
        w = workloads.ALL_WORKLOADS[name](scale=MESH_SCALE, device="cpu")
        cfgs = ALL_RULES[rule].configs(w.plan, w.catalog)
        assert cfgs, f"{rule} must apply to {name}"
        plan = ALL_RULES[rule].apply(w.plan, w.catalog, cfgs[0])
        g = stage_graph.build(plan, w.catalog, profile=cost.DeviceProfile.detect("cpu"),
                              ways=ways)
        d = g.partitioned_decisions()
        pplan = g.realize(d)
        assert any(isinstance(n, (ph.PBlockedMatmul, ph.PForestRelational))
                   for n in _walk(pplan.root)), name
        want = ph.run(g.realize(replicated(g, d)), dict(w.catalog.tables))
        got = run_partitioned(pplan, dict(w.catalog.tables), mesh)
        assert_tables_equal(want, got, f"{name}/{rule}/row")
        _save(out_dir, rank, f"{name}.{rule}", got)
        say(rank, f"{name}/{rule}: OK")


def join_plans(ways: int, lcap: int, rcap: int) -> dict:
    """Hash- and row-partitioned PJoin over tables L(k, v) and R(rk, w),
    and a row-partitioned PCrossJoin, as explicit physical plans."""
    from repro_torch.core import mesh as mesh_util
    from repro_torch.core import physical as ph
    blk = mesh_util.row_block(lcap, ways)

    def rp(child, op, cin, cout, key=None):
        return ph.PRepartition(child, op=op, ways=ways, in_capacity=cin,
                               out_capacity=cout, key=key)

    roots = {
        "hash": rp(ph.PJoin(left=rp(ph.PScan("L"), "bucket", lcap, lcap, "k"),
                            right=rp(ph.PScan("R"), "bucket", rcap, rcap, "rk"),
                            left_key="k", right_key="rk", rprefix="r_"),
                   "combine", lcap, lcap),
        "row": rp(ph.PJoin(left=rp(ph.PScan("L"), "slice", lcap, blk), right=ph.PScan("R"),
                           left_key="k", right_key="rk", rprefix="r_"),
                  "allgather", blk, lcap),
        "xjoin": rp(ph.PCrossJoin(left=rp(ph.PScan("L"), "slice", lcap, blk),
                                  right=ph.PScan("R"), aprefix="a_", bprefix="b_"),
                    "allgather", blk * rcap, lcap * rcap),
    }
    return {k: ph.PhysicalPlan(root=r, registry=None, ways=ways) for k, r in roots.items()}


def _join_tables(keys, lvalid, rkeys, rvalid, rng, device):
    import torch
    from repro_torch.relational.table import Table
    n, m = len(keys), len(rkeys)
    lt = Table.from_columns({"k": np.asarray(keys, np.int32),
                             "v": rng.standard_normal(n).astype(np.float32)},
                            valid=np.asarray(lvalid), device=device)
    rt = Table.from_columns({"rk": np.asarray(rkeys, np.int32),
                             "w": rng.standard_normal(m).astype(np.float32)},
                            valid=np.asarray(rvalid), device=device)
    assert lt.valid.dtype == rt.valid.dtype == torch.bool
    return lt, rt


def _check_joins(lt, rt, mesh, ways, label):
    from repro_torch.relational import ops
    tables = {"L": lt, "R": rt}
    plans = join_plans(ways, lt.capacity, rt.capacity)
    want_join = ops.fk_join(lt, rt, "k", "rk", "r_")
    want_x = ops.cross_join(lt, rt, "a_", "b_")
    for flavour, pplan in plans.items():
        want = want_x if flavour == "xjoin" else want_join
        assert_tables_equal(want, run_partitioned(pplan, tables, mesh), f"{label}/{flavour}")


def skew_cases(ways: int, seed: int = 7) -> dict:
    """Left join keys that corner bucket partitioning: every key in one
    bucket, buckets with no keys, and a row count ``ways`` doesn't divide."""
    rng = np.random.default_rng(seed)
    return {
        "all-one-bucket": np.full(37, 2 * ways + 5, np.int32),
        "empty-buckets": (rng.integers(0, 3, 41) * ways + 3).astype(np.int32),
        "uniform-53": rng.integers(0, 100, 53).astype(np.int32),
    }


def _check_skew(mesh, ways, rank, device="cpu"):
    rng = np.random.default_rng(7)
    for label, keys in skew_cases(ways).items():
        rkeys = np.unique(np.concatenate([keys, np.arange(6, dtype=np.int32)]))
        lt, rt = _join_tables(keys, rng.random(len(keys)) < 0.8, rkeys,
                              np.ones(len(rkeys), bool), rng, device)
        _check_joins(lt, rt, mesh, ways, f"skew {label}")
        say(rank, f"skew {label}: OK")


LCAP, RCAP, JOIN_EXAMPLES = 24, 40, 12  # tests/test_partitioned.py's property test


def _check_join_property(mesh, ways, rank):
    """The reference's hypothesis test on skewed keys, as seeded examples
    (every rank must draw the same ones): keys over the right table's range
    with extra mass on one key, random left and right masks."""
    rng = np.random.default_rng(11)
    for i in range(JOIN_EXAMPLES):
        keys = np.where(rng.random(LCAP) < 0.4, 5, rng.integers(0, RCAP, LCAP))
        lt, rt = _join_tables(keys, rng.random(LCAP) < 0.7, np.arange(RCAP),
                              rng.random(RCAP) < 0.7, rng, "cpu")
        _check_joins(lt, rt, mesh, ways, f"property example {i}")
    say(rank, f"skewed join property ({JOIN_EXAMPLES} examples): OK")


def partition_budget(plan, catalog, ways: int, profile) -> tuple:
    """(replicated peak, partitioned peak, budget) of a query on ``ways``
    ranks: the per-device peaks of the tree-order realization (the peak
    ``QueryServer`` routes on) and of the maximally row-partitioned one
    (costed lowering's second descent seed), and a budget halfway between
    them. The tree-order plan busts that budget, so a server routes the
    query to the partitioned executable; the seed fits it, so the descent
    starts from a plan that fits (a budget below the seed's peak can prune
    every candidate the descent scores, as it did rec_q3@20's)."""
    from repro_torch.core import cost, stage_graph
    g = stage_graph.build(plan, catalog, profile=profile, ways=ways)
    rep = cost.phys_peak_memory(g.realize(g.default_decisions()), catalog, profile)
    part = cost.phys_peak_memory(g.realize(g.partitioned_decisions()), catalog, profile)
    return rep, part, (rep + part) / 2.0


def _check_budgeted_serving(mesh, ways, rank, out_dir):
    """A per-device budget below the unpartitioned working set routes the
    oversized query through the partitioned path, end to end."""
    from repro_torch.core import cost, costed_lowering
    from repro_torch.core.executor import execute
    from repro_torch.data import workloads
    from repro_torch.serving import QueryServer
    w = workloads.ALL_WORKLOADS["retail_q3"](scale=MESH_SCALE, device="cpu")
    profile = cost.DeviceProfile.detect("cpu")
    budget = partition_budget(w.plan, w.catalog, ways, profile)[2]
    low = costed_lowering.lower_costed(w.plan, w.catalog, profile=profile,
                                       memory_budget=budget, ways=ways)
    assert low.plan.ways == ways and low.plan.parts, low.signature
    assert low.peak_memory <= budget
    assert low.budget_pruned > 0 and not low.budget_pruned_all

    srv = QueryServer(max_batch_size=4, max_wait_s=3600.0, mesh=mesh,
                      memory_budget=budget, device="cpu")
    req = srv.submit(w.plan, w.catalog)
    assert req.partitioned
    assert "#be=part" in req.key and "#mesh=" in req.key
    assert any(tok.startswith("pt") for tok in req.key.split("#cl=")[1].split(";")), req.key
    assert req.key == srv.cache.key(w.plan, w.catalog, mesh=mesh)
    assert srv.drain() == 1 and req.error is None, req.error
    assert srv.stats()["partitioned_dispatches"] == 1
    want = execute(w.plan, w.catalog, device="cpu")
    assert_canonical_close(want.canonical(), req.result.canonical(), "served-oversized",
                           PARTITION_TOL)
    _save(out_dir, rank, "served-oversized", req.result)

    # repeated traffic of the signature hits the same executable
    t0 = srv.cache.traces
    req2 = srv.submit(w.plan, w.catalog, workloads.roll_tables(dict(w.catalog.tables), 1))
    assert srv.drain() == 1 and req2.error is None, req2.error
    assert srv.cache.traces == t0, "a warm partitioned dispatch rebuilt"
    assert int(req2.result.valid.sum()) > 0
    say(rank, "budgeted serving: OK")


def _check_cache_entries(mesh, ways, rank):
    """tests/test_partitioned.py's multi-device checks: the partitioned
    entry is first class, a kernel override composes with it, a 1-wide
    mesh falls back to the plain entry, and the server routes an oversized
    query (the feedback export carries its multi-rank features)."""
    from repro_torch.core import cost
    from repro_torch.core import mesh as mesh_util
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.data import workloads
    from repro_torch.serving import QueryServer, feedback
    profile = cost.DeviceProfile.detect("cpu")
    w = workloads.retail_q3(scale=MESH_SCALE, device="cpu")
    budget = partition_budget(w.plan, w.catalog, ways, profile)[2]

    cache = PlanCache(device="cpu")
    cache.profile.memory_budget = budget
    key = cache.key(w.plan, w.catalog, mesh=mesh)
    assert "#be=part" in key and "#mesh=" in key
    assert any(t.startswith("pt") for t in key.split("#cl=")[1].split(";"))
    fn = cache.get_or_compile_partitioned(w.plan, w.catalog, mesh)
    assert cache._cache.get(key) is fn  # the key IS the entry's key
    plain = cache.get_or_compile(w.plan, w.catalog)
    assert plain is not fn
    assert_tables_equal(plain(dict(w.catalog.tables)), fn(dict(w.catalog.tables)),
                        "partitioned entry")
    t0 = cache.traces
    assert cache.get_or_compile_partitioned(w.plan, w.catalog, mesh) is fn
    assert cache.traces == t0
    say(rank, "partitioned cache entry is first class: OK")

    cache = PlanCache(device="cpu")
    cache.profile.memory_budget = budget
    fn = cache.get_or_compile_partitioned(w.plan, w.catalog, mesh, backend="torch")
    fn_plain = cache.get_or_compile_partitioned(w.plan, w.catalog, mesh)
    assert any("#be=part" in k and "#nbe=torch" in k for k in cache._cache._data)
    assert cache._cache.get(cache.key(w.plan, w.catalog, mesh=mesh, backend="torch")) is fn
    a, b = fn(dict(w.catalog.tables)), fn_plain(dict(w.catalog.tables))
    assert bool((a.valid == b.valid).all())
    say(rank, "partitioned composes with a backend override: OK")

    small = workloads.simple_q1(scale=MESH_SCALE, device="cpu")
    cache = PlanCache(device="cpu")
    one = mesh_util.data_mesh(1, device="cpu")
    assert mesh_util.batch_ways(one) == 1 and not mesh_util.can_shard(one, 8)
    assert (cache.get_or_compile_partitioned(small.plan, small.catalog, one)
            is cache.get_or_compile(small.plan, small.catalog))
    say(rank, "1-wide mesh falls back to the plain entry: OK")

    srv = QueryServer(max_batch_size=4, max_wait_s=3600.0, mesh=mesh,
                      memory_budget=budget, device="cpu")
    req = srv.submit(w.plan, w.catalog)
    assert req.partitioned and "#be=part" in req.key
    fits = workloads.simple_q1(scale=0.1, device="cpu")
    r2 = srv.submit(fits.plan, fits.catalog)
    assert not r2.partitioned and "#be=part" not in r2.key
    assert srv.drain() == 2
    assert req.error is None and r2.error is None, (req.error, r2.error)
    assert srv.stats()["partitioned_dispatches"] == 1
    sig = srv.signatures[req.key]
    assert sig.partitioned_dispatches == 1 and sig.ways == ways
    e = [x for x in feedback.export_signature_stats(srv) if x.key == req.key][0]
    assert e.partitioned_dispatches == 1 and e.ways == ways
    say(rank, "server routes the oversized query to the partitioned path: OK")


def _check_disagreement_raises(mesh, ways, rank):
    """Ranks whose plans differ fail at the executable's first call, on
    every rank, instead of entering mismatched collectives."""
    from repro_torch.core import cost
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.data import workloads
    w = workloads.retail_q3(scale=MESH_SCALE, device="cpu")
    cache = PlanCache(device="cpu")
    cache.profile.memory_budget = partition_budget(w.plan, w.catalog, ways,
                                                   cost.DeviceProfile.detect("cpu"))[2]
    # rank 0 alone overrides the kernel backend: its key differs
    fn = cache.get_or_compile_partitioned(w.plan, w.catalog, mesh,
                                          backend="torch" if rank == 0 else None)
    try:
        fn(dict(w.catalog.tables))
    except RuntimeError as e:
        assert "disagree" in str(e), e
    else:
        raise AssertionError("ranks that disagree about the plan ran it")
    say(rank, "ranks that disagree about the plan raise: OK")


def partitioned_suite(rank: int, ways: int, out_dir: Optional[str] = None) -> None:
    """The rank body of the PartSpec layer's proof (see module docstring)."""
    from repro_torch.core import mesh as mesh_util
    from repro_torch.data import workloads
    mesh = mesh_util.data_mesh(device="cpu")
    assert mesh_util.batch_ways(mesh) == ways
    for name in sorted(workloads.ALL_WORKLOADS):
        _check_workload(name, mesh, ways, rank, out_dir)
    say(rank, f"all {len(workloads.ALL_WORKLOADS)} workloads: partitioned == one device")
    _check_r3(mesh, ways, rank, out_dir)
    _check_skew(mesh, ways, rank)
    _check_join_property(mesh, ways, rank)
    _check_budgeted_serving(mesh, ways, rank, out_dir)
    _check_cache_entries(mesh, ways, rank)
    _check_disagreement_raises(mesh, ways, rank)
    say(rank, "partitioned suite: OK")


# ---------------------------------------------------------------------------
# the sharded (batch-axis) suite
# ---------------------------------------------------------------------------

def _agree(a, b, what: str) -> None:
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy(), err_msg=f"{what}.valid")
    for k in a.columns:
        x, y = a[k].numpy(), b[k].numpy()
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=PARTITION_TOL, atol=PARTITION_TOL,
                                       err_msg=f"{what}.{k}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what}.{k}")


def _check_sharded_workload(name, mesh, rank, out_dir):
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.data import workloads
    w = workloads.ALL_WORKLOADS[name](scale=MESH_SCALE, device="cpu")
    tabs = workloads.rolled_instances(dict(w.catalog.tables), MESH_BATCH)
    cache = PlanCache(device="cpu")
    run_seq = cache.get_or_compile(w.plan, w.catalog)
    seq = [run_seq(t) for t in tabs]
    bat = cache.get_or_compile_batched(w.plan, w.catalog, MESH_BATCH)(tuple(tabs))
    shd = cache.get_or_compile_sharded(w.plan, w.catalog, MESH_BATCH, mesh)(tuple(tabs))
    # the sharded entry is its own build, not a fallback hit on the batched one
    assert cache.traces == 3, f"{name}: expected 3 builds, got {cache.traces}"
    for i in range(MESH_BATCH):
        s, b, h = seq[i], bat[i], shd[i]
        assert set(h.columns) == set(s.columns) == set(b.columns)
        _agree(h, b, f"{name}[{i}] sharded vs batched")
        _agree(h, s, f"{name}[{i}] sharded vs sequential")
        _agree(b, s, f"{name}[{i}] batched vs sequential")
    _save(out_dir, rank, f"{name}.sharded0", shd[0])
    say(rank, f"{name}: OK")


def _check_sharded_server(mesh, ways, rank):
    """The server shards one full group (one dispatch, results equal to the
    vmapped program) and falls back to the batched executable for a
    remainder the rank count doesn't divide; the feedback fit sees the
    sharded dispatches as multi-rank samples."""
    from repro_torch.core import cost
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.data import workloads
    from repro_torch.serving import QueryServer, feedback
    w = workloads.ALL_WORKLOADS["simple_q1"](scale=MESH_SCALE, device="cpu")
    base = dict(w.catalog.tables)
    ticks = iter(range(10 ** 6))
    srv = QueryServer(max_batch_size=MESH_BATCH, max_wait_s=3600.0, mesh=mesh,
                      device="cpu", clock=lambda: float(next(ticks)))
    reqs = [srv.submit(w.plan, w.catalog, workloads.roll_tables(base, i))
            for i in range(MESH_BATCH)]
    assert srv.step() == MESH_BATCH  # one full group, one dispatch
    assert srv.executor.sharded_dispatches == 1
    assert all(r.done and r.error is None and r.batch_size == MESH_BATCH for r in reqs)
    refs = PlanCache(device="cpu").get_or_compile_batched(w.plan, w.catalog, MESH_BATCH)(
        tuple(workloads.roll_tables(base, i) for i in range(MESH_BATCH)))
    for i, (r, ref) in enumerate(zip(reqs, refs)):
        _agree(r.result, ref, f"served request {i}")

    rest = [srv.submit(w.plan, w.catalog, workloads.roll_tables(base, i)) for i in range(3)]
    assert srv.drain() == 3
    assert all(r.done and r.error is None for r in rest)
    assert srv.executor.sharded_dispatches == 1  # unchanged: fallback path
    assert srv.stats()["sharded_dispatches"] == 1
    (sig,) = srv.signatures.values()
    assert sig.sharded_dispatches == 1 and sig.ways == ways

    samples = []
    fit = cost.fit_profile

    def recording(s, prior, **kw):
        samples.extend(s)
        return fit(s, prior, **kw)
    feedback.cost.fit_profile = recording
    try:
        feedback.calibrate_profile(feedback.export_signature_stats(srv),
                                   cost.DeviceProfile.detect("cpu"))
    finally:
        feedback.cost.fit_profile = fit
    # 1 of 2 dispatches sharded: the fit takes the signature as multi-rank
    assert [b.n_coll for b, _, _ in samples] == [float(ways)], samples
    say(rank, "server: OK")


def _check_sharded_policy(mesh, ways, rank):
    """tests/test_serving_sharded.py's mesh checks: the mesh's shape and
    signature, the eligibility policy on 2-wide meshes, a 1-wide mesh
    falling back to the batched entry, the sharded key first class, and a
    backend override disabling sharding."""
    from repro_torch.core import mesh as mesh_util
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.data import workloads
    from repro_torch.serving import QueryServer
    assert mesh.mesh_dim_names == ("data",)
    assert mesh_util.batch_ways(mesh) == ways
    assert mesh_util.mesh_signature(mesh) == f"data={ways}"
    for bad in (ways + 1, 0, 3):
        try:
            mesh_util.data_mesh(bad, device="cpu")
        except ValueError:
            pass
        else:
            raise AssertionError(f"data_mesh({bad}) on {ways} ranks")
    one = mesh_util.data_mesh(1, device="cpu")
    two = mesh_util.data_mesh(2, device="cpu")
    assert mesh_util.batch_ways(one) == 1 and not mesh_util.can_shard(one, 8)
    assert mesh_util.can_shard(two, 4) and not mesh_util.can_shard(two, 3)
    assert not mesh_util.can_shard(two, 1) and not mesh_util.can_shard(None, 8)

    w = workloads.ALL_WORKLOADS["simple_q1"](scale=MESH_SCALE, device="cpu")
    cache = PlanCache(device="cpu")
    fb = cache.get_or_compile_sharded(w.plan, w.catalog, 2, one)
    assert cache.stats.misses == 1 and len(cache._cache) == 1
    assert cache.get_or_compile_batched(w.plan, w.catalog, 2) is fb
    assert len(fb(tuple(workloads.rolled_instances(dict(w.catalog.tables), 2)))) == 2

    cache = PlanCache(device="cpu")
    fsh = cache.get_or_compile_sharded(w.plan, w.catalog, 2, two)
    fbat = cache.get_or_compile_batched(w.plan, w.catalog, 2)
    assert fsh is not fbat and cache.stats.misses == 2
    assert any("#be=sharded" in k and "#mesh=data=2" in k for k in cache._cache._data)
    assert cache.get_or_compile_sharded(w.plan, w.catalog, 2, two) is fsh
    try:
        fsh(tuple(workloads.rolled_instances(dict(w.catalog.tables), 3)))
    except ValueError:
        pass
    else:
        raise AssertionError("a sharded executable took another batch size")

    srv = QueryServer(max_batch_size=2, max_wait_s=3600.0, backend="torch", mesh=two,
                      device="cpu")
    base = dict(w.catalog.tables)
    reqs = [srv.submit(w.plan, w.catalog, workloads.roll_tables(base, i)) for i in range(2)]
    assert srv.step() == 2 and all(r.done and r.error is None for r in reqs)
    st = srv.stats()
    assert st["sharded_dispatches"] == 0 and st["dispatches"] == 1
    assert any("#be=torch" in k for k in srv.cache._cache._data)
    assert not any("#be=sharded" in k for k in srv.cache._cache._data)
    say(rank, "mesh policy, fallback and keys: OK")


def sharded_suite(rank: int, ways: int, out_dir: Optional[str] = None) -> None:
    """The rank body of the batch-axis proof (see module docstring)."""
    from repro_torch.core import mesh as mesh_util
    from repro_torch.data import workloads
    mesh = mesh_util.data_mesh(device="cpu")
    assert mesh_util.can_shard(mesh, MESH_BATCH)
    for name in sorted(workloads.ALL_WORKLOADS):
        _check_sharded_workload(name, mesh, rank, out_dir)
    say(rank, f"all {len(workloads.ALL_WORKLOADS)} workloads: "
              "sharded == batched == sequential")
    _check_sharded_server(mesh, ways, rank)
    _check_sharded_policy(mesh, ways, rank)
    say(rank, "sharded suite: OK")


def fault_suite(rank: int, ways: int, out_dir: Optional[str] = None) -> None:
    """The rank body of the fault check: one rank's bad payload fails the
    run. Every rank submits the same B 8 micro-batch of simple_q1, except
    that the last rank's copy of the last request has tables one row short.
    Its batch fails to stack there while the other ranks run their slices
    into the all-gather; the last rank raises out of ``drain`` (it prints
    the error first), and the others fail when its group goes down, well
    inside the group's timeout."""
    from repro_torch.core import mesh as mesh_util
    from repro_torch.data import workloads
    from repro_torch.relational.table import Table
    from repro_torch.serving import QueryServer
    mesh = mesh_util.data_mesh(device="cpu")
    w = workloads.ALL_WORKLOADS["simple_q1"](scale=MESH_SCALE, device="cpu")
    base = dict(w.catalog.tables)
    srv = QueryServer(max_batch_size=MESH_BATCH, max_wait_s=3600.0, mesh=mesh, device="cpu")
    for i in range(MESH_BATCH):
        tables = workloads.roll_tables(base, i)
        if rank == ways - 1 and i == MESH_BATCH - 1:
            tables = {k: Table(columns={c: v[:-1] for c, v in t.columns.items()},
                               valid=t.valid[:-1]) for k, t in tables.items()}
        srv.submit(w.plan, w.catalog, tables)
    try:
        srv.drain()
    except Exception as e:
        print(f"rank {rank}: drain raised {type(e).__name__}", flush=True)
        raise
    print(f"rank {rank}: drain returned, {srv.failed} requests failed", flush=True)


# ---------------------------------------------------------------------------
# the LM on a (data, model) mesh
# ---------------------------------------------------------------------------

# (data, model) meshes of the 8 ranks, and a (pod, data, model) one
LM_MESH_SHAPES = ((2, 4), (1, 8), (2, 2, 2))
LM_MESH_ARCHS = ("granite-3-2b", "granite-moe-1b-a400m", "deepseek-v2-236b", "zamba2-1.2b")
LM_MESH_DTYPE = {(2, 4): "bfloat16", (1, 8): "float32"}  # of each 2-D mesh's LM runs
# the (pod, data, model) mesh's LM runs: (arch, dtype)
LM_POD_RUNS = (("granite-3-2b", "float32"), ("granite-3-2b", "bfloat16"),
               ("granite-moe-1b-a400m", "float32"))
LM_MESH_BATCH, LM_MESH_PROMPT, LM_MESH_MAX_LEN, LM_MESH_STEPS = 4, 14, 64, 3
LM_MESH_FRAMES = 7  # the encoder-decoder's frames (its prefill's enc_embeds)
LM_F32_TOL, LM_BF16_TOL = 2e-4, 3e-2  # the port's LM bars (tests/test_torch_lm_families.py)
ATTN_SHAPE = (8, 2, 16)  # query heads, KV heads, head dim of the attention cases


def lm_tol(dtype: str) -> float:
    return LM_F32_TOL if dtype == "float32" else LM_BF16_TOL


def mesh_tag(shape: tuple) -> str:
    """``2x4``, ``2x2x2``: a mesh shape in a case's label."""
    return "x".join(map(str, shape))


def host_mesh(shape: tuple, device="cpu"):
    """``core.mesh.make_host_mesh`` of a (data, model) or (pod, data,
    model) ``shape``."""
    from repro_torch.core import mesh as mesh_util
    if len(shape) == 3:
        return mesh_util.make_host_mesh(shape[1], shape[2], pod=shape[0], device=device)
    return mesh_util.make_host_mesh(*shape, device=device)


def lm_mesh_cases(shape: tuple) -> list:
    """The cases of the ``lm-mesh`` suite on a (data, model) mesh of
    ``shape``, in the order the ranks run them; on the (pod, data, model)
    mesh, ``prefill(mesh=)`` and 3 decode steps of ``LM_POD_RUNS``. Each is
    a dict with a unique ``label``; ``lm_mesh_inputs`` makes its inputs."""
    tag = mesh_tag(shape)
    if len(shape) == 3:
        return [dict(label=f"{tag}/lm/{dtype}/{arch}", kind="lm", arch=arch, dtype=dtype,
                     prompt=LM_MESH_PROMPT) for arch, dtype in LM_POD_RUNS]
    cases = []
    for dtype in ("float32", "bfloat16"):
        # len 1: every rank but the first holds no valid slot; b 1: the
        # batch does not divide over data and is replicated
        for b, n in ((4, 1), (4, 37), (4, LM_MESH_MAX_LEN), (1, 37)):
            cases.append(dict(label=f"{tag}/attn/{dtype}/b{b}/len{n}", kind="attn",
                              dtype=dtype, b=b, len=n))
        # 600 tokens: 300 a data rank on (2, 4), past the dropless 256;
        # 4 experts do not divide over 8 model ranks, 8 do
        for t, e in ((8, 4), (600, 4), (8, 8)):
            cases.append(dict(label=f"{tag}/moe/{dtype}/t{t}/e{e}", kind="moe",
                              dtype=dtype, t=t, experts=e))
        for n in (1, 37):
            cases.append(dict(label=f"{tag}/mla/{dtype}/len{n}", kind="mla", dtype=dtype,
                              b=LM_MESH_BATCH, len=n))
    dtype = LM_MESH_DTYPE[shape]
    for arch in LM_MESH_ARCHS:
        cases.append(dict(label=f"{tag}/lm/{dtype}/{arch}", kind="lm", arch=arch,
                          dtype=dtype, prompt=LM_MESH_PROMPT))
    if shape == (2, 4):
        # the last two steps write the last slot (len clamped to max_len - 1)
        cases.append(dict(label=f"{tag}/lm/{dtype}/granite-3-2b/clamped", kind="lm",
                          arch="granite-3-2b", dtype=dtype, prompt=LM_MESH_MAX_LEN - 2))
        cases.append(dict(label=f"{tag}/serve/float32/granite-moe-1b-a400m", kind="serve",
                          arch="granite-moe-1b-a400m", dtype="float32"))
    return cases


def lm_mesh_config(case: dict, smoke_config: Callable):
    """The case's model config from ``smoke_config`` (either package's
    ``get_smoke_config``), in the case's type, with the case's
    ``n_heads`` where it names one."""
    import dataclasses
    arch = case.get("arch", "deepseek-v2-236b" if case["kind"] == "mla"
                    else "granite-moe-1b-a400m")
    cfg = dataclasses.replace(smoke_config(arch), dtype=case["dtype"])
    if case.get("heads"):
        cfg = dataclasses.replace(cfg, n_heads=case["heads"])
    if case["kind"] == "moe":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               n_experts=case["experts"]))
    return cfg


def seeded_lm_params(shapes: dict, seed: int) -> dict:
    """float32 numpy params of the shape tree ``shapes`` (``lm.param_shapes``)
    by ``lm.init_params``'s scheme (norms and 1-D leaves one, ``dt_bias``
    -2, ``A_log`` 0, ``D_skip`` 1, the rest normal / sqrt(fan_in)), from a
    numpy seed, in sorted key order; each package casts them to its type."""
    from repro_torch.models.lm import CONSTANTS, NORMS
    rng = np.random.default_rng(seed)

    def mk(name, shape):
        if name in NORMS or len(shape) == 1:
            return np.ones(shape, np.float32)
        if name in CONSTANTS:
            return np.full(shape, CONSTANTS[name], np.float32)
        return (rng.standard_normal(shape) / np.sqrt(max(shape[-2], 1))).astype(np.float32)

    def build(tree):
        return {n: build(v) if isinstance(v, dict) else mk(n, tuple(v))
                for n, v in sorted(tree.items())}

    return build(shapes)


def lm_mesh_inputs(case: dict, cfg) -> dict:
    """The case's inputs as float32 / int32 numpy arrays (each package
    casts them to the case's type), from a seed of its label."""
    import zlib
    rng = np.random.default_rng(zlib.crc32(case["label"].encode()))

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    kind = case["kind"]
    if kind == "attn":
        hq, hkv, hd = ATTN_SHAPE
        b, s = case["b"], LM_MESH_MAX_LEN
        return {"q": normal(b, hq, hd), "k": normal(b, s, hkv, hd), "v": normal(b, s, hkv, hd)}
    if kind == "moe":
        d, mo = cfg.d_model, cfg.moe
        return {"x": normal(case["t"], d), "router": normal(d, mo.n_experts, scale=d ** -0.5),
                "e_gate": normal(mo.n_experts, d, mo.d_expert, scale=d ** -0.5),
                "e_in": normal(mo.n_experts, d, mo.d_expert, scale=d ** -0.5),
                "e_out": normal(mo.n_experts, mo.d_expert, d, scale=mo.d_expert ** -0.5)}
    if kind == "mla":
        m, b, h, s = cfg.mla, case["b"], cfg.n_heads, LM_MESH_MAX_LEN
        return {"q_c": normal(b, h, m.kv_lora), "q_pe": normal(b, h, m.rope_dim),
                "ckv": normal(b, s, m.kv_lora), "kpe": normal(b, s, m.rope_dim)}
    from repro_torch.models import lm
    out = {"params": seeded_lm_params(lm.param_shapes(cfg), zlib.crc32(case["arch"].encode()))}
    if kind == "lm":
        out["prompt"] = rng.integers(0, cfg.vocab, (LM_MESH_BATCH, case["prompt"])).astype(np.int32)
        out["steps"] = rng.integers(0, cfg.vocab, (LM_MESH_STEPS, LM_MESH_BATCH)).astype(np.int32)
        if cfg.kind == "encdec":
            out["enc"] = normal(LM_MESH_BATCH, LM_MESH_FRAMES, cfg.d_model)
    else:  # serve: 6 prompts of 4-11 tokens, 4 new tokens each
        out["prompts"] = [rng.integers(0, cfg.vocab, rng.integers(4, 12)).astype(np.int32)
                          for _ in range(6)]
        out["max_new"] = 4
    return out


def mla_scale(cfg) -> float:
    return (cfg.mla.nope_dim + cfg.mla.rope_dim) ** -0.5


def _lm_mesh_case(case: dict, mesh, say_line: Callable) -> np.ndarray:
    """Runs one case on this rank of ``mesh`` and on one device (this
    process, no collective); holds the first to the second at the case's
    bar (``lm_tol``) and returns the first as float32 numpy."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import layers as L, lm, sharding
    cfg = lm_mesh_config(case, get_smoke_config)
    inp = lm_mesh_inputs(case, cfg)
    dt = getattr(torch, case["dtype"])
    kind = case["kind"]
    t = {k: torch.from_numpy(v) for k, v in inp.items() if isinstance(v, np.ndarray)}
    note = ""

    def cut(x, spec):
        return sharding.local_block(x, spec, mesh, ("pod", "data", "model"))

    if kind in ("attn", "mla"):
        names = ("q", "k", "v") if kind == "attn" else ("q_c", "q_pe", "ckv", "kpe")
        args = [t[n] if n == "q_c" else t[n].to(dt) for n in names]
        b = args[0].shape[0]
        b_ax = sharding.batch_spec(mesh, b)[0]
        spec = (b_ax, ("model",)) + (None,) * (args[-1].ndim - 2)
        local = [cut(a, spec) for a in args[len(names) - 2:]]
        clen = torch.tensor(case["len"], dtype=torch.int32)
        if kind == "attn":
            got = L.sharded_decode_attention(args[0], *local, clen, mesh)
            want = lm._decode_attn(*args, clen)
        else:
            got = lm.mla_latent_attention(*args[:2], *local, clen, mla_scale(cfg), mesh)
            want = lm.mla_latent_attention(*args, clen, mla_scale(cfg))
        ways = sharding.axis_size(mesh, "model")
        empty = sum(case["len"] <= r * (LM_MESH_MAX_LEN // ways) for r in range(ways))
        note = (f"rows {'split over data' if b_ax else 'replicated'}, ranks over model "
                f"holding no valid slot: {empty}")
    elif kind == "moe":
        w = {k: t[k].to(dt) for k in ("router", "e_gate", "e_in", "e_out")}
        split = sharding.sharded_experts(cfg, mesh)
        loc = {k: (cut(v, (("model",), None, None)) if split and k != "router" else v)
               for k, v in w.items()}
        x = t["x"].to(dt)
        got = L.moe_block(x, loc["router"], loc["e_gate"], loc["e_in"], loc["e_out"], cfg, mesh)
        want = L.moe_block(x, w["router"], w["e_gate"], w["e_in"], w["e_out"], cfg)
        rows = sharding.batch_rows(mesh, x.shape[0])
        t_loc = x.shape[0] if rows is None else rows.stop - rows.start
        note = (f"experts {'split over model' if split else 'whole: E % model != 0'}, "
                f"{t_loc} tokens a rank, capacity {L.capacity(cfg, t_loc)}")
        if x.shape[0] > L.DROPLESS_TOKENS and L.capacity(cfg, t_loc) != L.capacity(
                cfg, x.shape[0]):
            # capacity counts the rank's tokens, as in the reference: one
            # device drops other assignments, so only JAX's shard_map compares
            say_line(f"{case['label']}: {note}; capacity differs from one device's "
                     f"{L.capacity(cfg, x.shape[0])}: held to JAX only")
            return {case["label"]: got.float().numpy()}
    else:
        whole = convert.lm_params_from_numpy(inp["params"], device="cpu", dtype=dt)
        if kind == "serve":
            (got, steps), (want, _) = (serve_tokens(cfg, whole, inp, m) for m in (mesh, None))
            np.testing.assert_array_equal(got, want, err_msg=case["label"])
            say_line(f"{case['label']}: {len(inp['prompts'])} requests in {steps} steps, "
                     "tokens == one device: OK")
            return {case["label"]: got.astype(np.float32)}
        params = sharding.shard_params(whole, cfg, mesh)
        srv = serve.Server(cfg, LM_MESH_BATCH, LM_MESH_MAX_LEN, device="cpu", params=whole,
                           mesh=mesh)
        logits, srv.cache = lm.prefill(params, cfg, t["prompt"], LM_MESH_MAX_LEN, mesh=mesh)
        got = [logits]
        for tok in t["steps"]:
            srv.decode(tok)
            got.append(srv.logits)
        got, want = torch.stack(got), _one_device_logits(cfg, whole, t["prompt"], t["steps"])
        note = (f"MoE experts {'split over model' if sharding.sharded_experts(cfg, mesh) else 'whole'}"
                if cfg.moe else "no MoE")
        if spread_case(case):
            return _saved_for_spread(case["label"], got, want, note, say_line)
    tol = lm_tol(case["dtype"])
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{case['label']}: {m}")
    say_line(f"{case['label']}: {note}; == one device, max|err|={err:.3g} (bar {tol:g}): OK")
    return {case["label"]: got.float().numpy()}


def _saved_for_spread(label: str, got, want, note: str, say_line: Callable) -> dict:
    """A ``spread_case``'s logits on the mesh (``got``) and on one device
    (``want``), both kept for the test, which holds them to each other at
    ``spread_bar`` (it alone has the reference's spread)."""
    err = float((got.float() - want.float()).abs().max())
    say_line(f"{label}: {note}; one device's logits kept (max|err|={err:.3g}), held in the "
             f"test at lm_tol + the reference's own mesh-to-one-device spread: OK")
    return {label: got.float().numpy(), label + ONE_DEVICE: want.float().numpy()}


def _one_device_logits(cfg, params, prompt, steps, enc=None):
    """``prefill`` (over the frames ``enc`` for the encoder-decoder) and a
    decode step a token of ``steps`` on one device: the logits [1 + steps,
    B, V]."""
    import torch
    from repro_torch.models import lm
    lg, cache = lm.prefill(params, cfg, prompt, LM_MESH_MAX_LEN, enc_embeds=enc)
    step = lm.make_decode_step(cfg)
    out = [lg]
    for tok in steps:
        lg, cache = step(params, cache, tok)
        out.append(lg)
    return torch.stack(out)


def _check_gather_fsdp(mesh, say_line: Callable) -> None:
    """``lm._gather_fsdp`` of one layer's FSDP weights, each cut to this
    rank's block by the training placement (``sharding.train_specs``
    without the stacked axis), gives each weight back whole over ``data``:
    the whole weight, or its block over ``model`` where the placement
    splits it there too (tensor parallelism)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm, sharding
    cfg = dataclasses.replace(get_smoke_config("deepseek-67b"), fsdp=True, dtype="float32")
    whole = lm.init_params(cfg, seed=3, device="cpu")
    specs = {k: sp[1:] for k, sp in
             sharding.train_specs(cfg, lm.param_shapes(cfg), mesh)["blocks"].items()}
    blk = {k: w[0] for k, w in whole["blocks"].items()}
    local = sharding.place(blk, specs, mesh)
    cut = sorted(k for k in blk if local[k].shape != blk[k].shape)
    assert cut
    got = lm._gather_fsdp(local, cfg, mesh, specs)
    for k, w in blk.items():
        model = tuple(ax if ax == ("model",) else None for ax in specs[k])
        assert torch.equal(got[k], sharding.place_leaf(w, model, mesh)), k
    say_line(f"_gather_fsdp over data={sharding.axis_size(mesh, 'data')}: "
             f"{cut} whole again over data: OK")


def lm_mesh_suite(rank: int, ways: int, out_dir: Optional[str] = None) -> None:
    """The rank body of the LM's mesh proof on 8 ranks: every case of
    ``lm_mesh_cases`` on the (2, 4), (1, 8) and (2, 2, 2) meshes, each held to this
    rank's one-device run of the same inputs; FSDP's gather. Every rank
    writes what it computed to ``out_dir/rank{rank}.npz`` (one array a
    case label), which the tests hold to JAX's ``shard_map`` results."""
    if ways != 8:
        raise ValueError(f"lm-mesh runs on 8 ranks, not {ways}")
    results = {}

    def line(text):
        say(rank, text)

    for shape in LM_MESH_SHAPES:
        mesh = host_mesh(shape)
        for case in lm_mesh_cases(shape):
            results.update(_lm_mesh_case(case, mesh, line))
        if len(shape) == 2 and shape[0] > 1:
            _check_gather_fsdp(mesh, line)
    if out_dir is not None:
        np.savez(Path(out_dir) / f"rank{rank}.npz", **results)
    say(rank, "lm-mesh suite: OK")


# ---------------------------------------------------------------------------
# tensor parallelism over model: every family on a mesh
# ---------------------------------------------------------------------------

# on (1, 8) the 4 smoke heads stay whole; xLSTM's 2 split only on (2, 2, 2)
TP_SHAPES = ((2, 4), (2, 2, 2), (1, 8))
TP_ARCHS = ("deepseek-67b", "deepseek-v2-236b", "granite-3-2b", "granite-moe-1b-a400m",
            "nemotron-4-15b", "qwen2-vl-72b", "seamless-m4t-medium", "stablelm-12b",
            "xlstm-1.3b", "zamba2-1.2b")
# the float32 xLSTM case whose mLSTM heads split over 4 model ranks: (arch,
# n_heads, mesh)
TP_HEADS_CASE = ("xlstm-1.3b", 4, (2, 4))
TP_MOE = ("deepseek-v2-236b", "granite-moe-1b-a400m")  # 4 experts in the smoke configs
TP_BATCH = 8  # rows of the loss's batch, of TRAIN_MESH_SEQ tokens
TP_SERVE_SHAPE = (2, 4)  # the mesh of the float32 serve loops


def tp_cases() -> list:
    """The cases of the ``tp`` suite, in the order the ranks run them: each
    arch's smoke config in float32 and bfloat16 on each mesh of
    ``TP_SHAPES``, and ``TP_HEADS_CASE`` (``heads``: its ``n_heads``) in
    float32; ``serve``: the float32 cases on ``TP_SERVE_SHAPE`` also run
    the serve loop. ``ref`` names the reference that the loss's gradient
    is held to: ``"one"`` where the experts split over more than one
    ``model`` rank (its mesh gradient is not its loss's, ROADMAP §3), else
    ``"mesh"``."""
    cases = []
    for shape in TP_SHAPES:
        for arch in TP_ARCHS:
            for dtype in ("float32", "bfloat16"):
                split = arch in TP_MOE and 4 % shape[-1] == 0
                cases.append(dict(label=f"{mesh_tag(shape)}/tp/{dtype}/{arch}", kind="lm",
                                  shape=shape, arch=arch, dtype=dtype, prompt=LM_MESH_PROMPT,
                                  ref="one" if split else "mesh",
                                  serve=dtype == "float32" and shape == TP_SERVE_SHAPE))
    arch, heads, shape = TP_HEADS_CASE
    cases.append(dict(label=f"{mesh_tag(shape)}/tp/float32/{arch}/h{heads}", kind="lm",
                      shape=shape, arch=arch, dtype="float32", prompt=LM_MESH_PROMPT,
                      heads=heads, ref="mesh", serve=False))
    return cases


def tp_inputs(case: dict, cfg) -> dict:
    """``lm_mesh_inputs`` of the case (params, prompt, steps), the serve
    loop's requests and the loss's batch, from seeds of its label."""
    import zlib
    out = lm_mesh_inputs(case, cfg)
    serve = lm_mesh_inputs(dict(case, kind="serve"), cfg)
    out.update(prompts=serve["prompts"], max_new=serve["max_new"],
               batch=train_mesh_batches(cfg, TP_BATCH, zlib.crc32(case["label"].encode()),
                                        1)[0])
    return out


# the bf16 smoke configs whose reference moves its logits past the LM bar
# between its own tensor-parallel mesh program (params under param_pspecs)
# and one device, on (2, 4), (2, 2, 2) and (1, 8): zamba2's by 0.046-0.097
# (its Mamba-2 states carry the partial sums' other rounding), xLSTM's by
# 0.061-0.168 (its mLSTM memories and sLSTM states carry it)
SPREAD_ARCHS = ("xlstm-1.3b", "zamba2-1.2b")
ONE_DEVICE = "#one-device"  # the key suffix of a rank's one-device logits


def spread_case(case: dict) -> bool:
    """Whether a case's logits on the mesh are held to one device's at
    ``spread_bar`` (in the tests) instead of ``lm_tol`` (on the ranks)."""
    return case["dtype"] == "bfloat16" and case.get("arch") in SPREAD_ARCHS


def spread_bar(dtype: str, spread: float) -> float:
    """The bar of a rank's mesh logits against its one-device logits where
    the reference's own mesh program is ``spread`` (max |difference|) off
    its one device: ``lm_tol`` more than that."""
    return lm_tol(dtype) + spread


def tp_bar(dtype: str) -> float:
    """The bar of the loss and of each gradient leaf (against its largest
    |g|): the port's training bar in float32, the LM bar in bfloat16."""
    return TRAIN_MESH_TOL if dtype == "float32" else LM_BF16_TOL


def tp_holds_grads(case: dict) -> bool:
    """Whether the case's gradients are held to JAX's, leaf by leaf: all
    but the MoEs' in bfloat16, whose top-k router moves their gradients by
    more than the bar on a rounding of its inputs (granite-moe's one-device
    bf16 gradient is 0.16 of the largest |g| off its own mesh run); there,
    as ``tests/test_torch_train_grads.py`` holds bfloat16, the loss only.
    ``spread_case``'s are held at the larger of ``tp_bar`` and the
    reference's own mesh-to-one-device spread (``tests/test_torch_tp.py``)."""
    return case["dtype"] == "float32" or case["arch"] not in TP_MOE


def serve_tokens(cfg, params, inp, mesh) -> tuple:
    """(each request's tokens [n, LM_MESH_MAX_LEN], -1 past its end; the
    steps taken) of ``launch.serve.serve`` over ``inp``'s prompts through a
    CPU ``Server(mesh=)`` holding the whole ``params``."""
    from repro_torch.launch import serve
    srv = serve.Server(cfg, LM_MESH_BATCH, LM_MESH_MAX_LEN, device="cpu", params=params,
                       mesh=mesh)
    reqs = [serve.Request(rid=i, prompt=p, max_new=inp["max_new"])
            for i, p in enumerate(inp["prompts"])]
    steps = serve.serve(srv, reqs)
    out = np.full((len(reqs), LM_MESH_MAX_LEN), -1, np.int32)
    for i, r in enumerate(reqs):
        out[i, :len(r.out)] = r.out
    return out, steps


def _tp_case(case: dict, mesh, say_line: Callable) -> dict:
    """One case on this rank: ``Server(mesh=)`` from whole params (each
    leaf's block checked against ``serve_specs``), ``prefill(mesh=)`` into
    its cache and 3 decode steps; in float32 the serve loop; the loss and
    gradients of ``value_and_grad(mesh=)`` from the training placement. Each
    is held to this rank's one-device run (the logits at ``lm_tol``, the
    served tokens exactly, the loss at ``tp_bar``, in float32 every gathered
    gradient leaf at ``tp_bar`` of its largest |g|). Returns this rank's
    results: the logits, tokens, loss and its block of every gradient."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import lm, sharding
    cfg = lm_mesh_config(case, get_smoke_config)
    inp = tp_inputs(case, cfg)
    dt = getattr(torch, case["dtype"])
    label = case["label"]
    whole = convert.lm_params_from_numpy(inp["params"], device="cpu", dtype=dt)
    shapes = lm.param_shapes(cfg)
    srv = serve.Server(cfg, LM_MESH_BATCH, LM_MESH_MAX_LEN, device="cpu", params=whole,
                       mesh=mesh)
    specs = flat_tree(sharding.serve_specs(cfg, shapes, mesh))
    for k, w in flat_tree(srv.params).items():
        want = sharding.block_shape(tuple(flat_tree(shapes)[k]), specs[k], mesh)
        if tuple(w.shape) != want:
            raise AssertionError(f"{label}: {k} of {tuple(w.shape)}, its block is {want}")
    split = sorted(k for k, sp in specs.items() if sharding.spec_axes(sp))
    prompt, steps = torch.from_numpy(inp["prompt"]), torch.from_numpy(inp["steps"])
    enc = torch.from_numpy(inp["enc"]) if "enc" in inp else None
    logits, srv.cache = lm.prefill(srv.params, cfg, prompt, LM_MESH_MAX_LEN, enc_embeds=enc,
                                   mesh=mesh)
    got = [logits]
    for tok in steps:
        srv.decode(tok)
        got.append(srv.logits)
    got = torch.stack(got).float()
    want = _one_device_logits(cfg, whole, prompt, steps, enc).float()
    tol, spread = lm_tol(case["dtype"]), spread_case(case)
    if spread:  # held to each other in the test (``spread_bar``)
        out = {f"{label}/lm": got.numpy(), f"{label}/lm{ONE_DEVICE}": want.numpy()}
    else:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol, msg=lambda m: f"{label}: {m}")
        out = {f"{label}/lm": got.numpy()}
    note = ", ".join(f"{k} block {list(v.shape)}" for k, v in srv.cache.items()
                     if k in ("k", "ckv", "conv", "mS", "sh", "enc_h"))
    if case["serve"]:
        tokens = serve_tokens(cfg, whole, inp, mesh)[0]
        np.testing.assert_array_equal(tokens, serve_tokens(cfg, whole, inp, None)[0],
                                      err_msg=f"{label} served tokens")
        out[f"{label}/serve"] = tokens
        note += f", {len(inp['prompts'])} requests served == one device"
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    tspecs = sharding.train_specs(cfg, shapes, mesh)
    loss, grads = lm.value_and_grad(sharding.place(whole, tspecs, mesh), cfg, batch, mesh)
    loss1, grads1 = lm.value_and_grad(whole, cfg, batch)
    bar = tp_bar(case["dtype"])
    np.testing.assert_allclose(float(loss), float(loss1), rtol=bar, atol=bar,
                               err_msg=f"{label} loss")
    worst = float("nan")
    if case["dtype"] == "float32":
        gathered = {k: v.float().numpy() for k, v in
                    flat_tree(sharding.unplace(grads, tspecs, mesh)).items()}
        worst = _assert_trees_close(gathered, {k: v.float().numpy() for k, v in
                                               flat_tree(grads1).items()}, label, bar)
    out[f"{label}/loss"] = np.asarray(float(loss), np.float64)
    out.update({f"{label}/grad/{k}": v.float().numpy() for k, v in flat_tree(grads).items()})
    err = float((got - want).abs().max())
    held = (f"logits == one device, max|err|={err:.3g} (bar {tol:g})" if not spread else
            f"logits {err:.3g} off one device's, both kept: the test holds them at lm_tol + "
            f"the reference's own mesh-to-one-device spread")
    if cfg.moe is not None and case["dtype"] == "bfloat16":
        note += "; " + routing_parts(cfg, srv.params, whole, prompt, mesh)
    say_line(f"{label}: {len(split)} leaves split over model ({', '.join(split)}); {note}; "
             f"{held}; loss {float(loss):.6f} "
             f"== one device's {float(loss1):.6f}; gradients worst |err| / max = {worst:.3g} "
             f"(bar {bar:g}): OK")
    return out


def routing_parts(cfg, params, whole, prompt, mesh) -> str:
    """Where ``prefill(mesh=)``'s expert choices part from one device's:
    each MoE layer's top-k experts of this rank's tokens (its rows of the
    prompt) against the one-device prefill's of the same tokens, as a
    line: the first layer where a token chooses otherwise, how many of the
    rank's tokens do there, and the router input's largest |difference|
    at that layer (every layer's where none parts)."""
    import torch
    from repro_torch.models import layers as L, lm, sharding
    seen, route = [], L.route

    def spy(x, w, k):
        v, e = route(x, w, k)
        seen.append((e.clone(), x.float().clone()))
        return v, e

    L.route = spy
    try:
        lm.prefill(params, cfg, prompt, LM_MESH_MAX_LEN, mesh=mesh)
        mine, seen[:] = list(seen), []
        lm.prefill(whole, cfg, prompt, LM_MESH_MAX_LEN)
        one = list(seen)
    finally:
        L.route = route
    rows = sharding.batch_rows(mesh, prompt.shape[0]) or slice(None)
    b = prompt.shape[0]
    worst = 0.0
    for layer, ((e, x), (e1, x1)) in enumerate(zip(mine, one)):
        e1, x1 = (t.view(b, -1, t.shape[-1])[rows].reshape(e.shape[0], -1) for t in (e1, x1))
        other = int((e.sort(-1).values != e1.sort(-1).values).any(-1).sum())
        diff = float((x - x1).abs().max())
        worst = max(worst, diff)
        if other:
            return (f"layer {layer}: {other} of {e.shape[0]} tokens choose other experts than "
                    f"one device's (router input max|diff| {diff:.3g})")
    return (f"every token's experts as one device's in all {len(mine)} layers (router "
            f"input max|diff| {worst:.3g})")


def _check_bf16_sum(mesh, say_line: Callable) -> np.ndarray:
    """``core.mesh.all_reduce_sum`` of bfloat16 values over ``model``
    equals their float32 sum rounded once, as XLA's promoted psum gives;
    gloo's own bfloat16 all-reduce rounds after every add. Returns the
    sum."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import mesh as mesh_util
    from repro_torch.models import sharding
    ways = sharding.axis_size(mesh, "model")
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((ways, 10000))
                         .astype(np.float32)).to(torch.bfloat16)
    mine = x[mesh_util.rank_of(mesh, "model")]
    got = mesh_util.all_reduce_sum(mine, mesh, "model")
    want = x.double().sum(0).to(torch.bfloat16)
    if not torch.equal(got, want):
        raise AssertionError(f"bf16 all_reduce_sum: {int((got != want).sum())} of "
                             f"{want.numel()} elements differ from the float32 sum rounded once")
    raw = mine.clone()
    dist.all_reduce(raw, group=mesh.get_group("model"))
    say_line(f"bf16 all-reduce over {ways} model ranks == the float32 sum rounded once "
             f"(gloo's own bf16 sum: {int((raw != want).sum())} of {want.numel()} elements "
             f"differ): OK")
    return got.float().numpy()


def tp_suite(rank: int, ways: int, out_dir: Optional[str] = None) -> None:
    """The rank body of the tensor-parallel proof on 8 ranks: every case of
    ``tp_cases`` (``_tp_case``); every rank writes its results to
    ``out_dir/rank{rank}.npz``, which the tests hold to JAX."""
    if ways != 8:
        raise ValueError(f"tp runs on 8 ranks, not {ways}")
    results, meshes = {}, {}

    def line(text):
        say(rank, text)

    for case in tp_cases():
        if case["shape"] not in meshes:
            meshes[case["shape"]] = host_mesh(case["shape"])
            if len(meshes) == 1:
                results["bf16-sum"] = _check_bf16_sum(meshes[case["shape"]], line)
        results.update(_tp_case(case, meshes[case["shape"]], line))
    if out_dir is not None:
        np.savez(Path(out_dir) / f"rank{rank}.npz", **results)
    say(rank, "tp suite: OK")


# ---------------------------------------------------------------------------
# LM training on a (data, model) mesh
# ---------------------------------------------------------------------------

TRAIN_MESH_BATCH, TRAIN_MESH_SEQ, TRAIN_MESH_MICRO = 16, 24, 2
TRAIN_MESH_STEPS = 2  # steps of each case (and of each half of the reshard and restore)
TRAIN_MESH_TOL = 2e-4  # the port's training bars (tests/test_torch_train_grads.py)
TRAIN_MESH_LR, TRAIN_MESH_EPS = 1e-2, 1e-3  # AdamW: eps 1e-3, as test_train_step_matches_jax
TRAIN_MESH_CLIP = 0.05  # the clip case's grad_clip, far below its gradient's norm
RESHARD = ("stablelm-12b", (2, 4), (4, 2))  # arch, the mesh before and after
RESTORE_SHAPE = (1, 4)  # the mesh of the new 4-rank group that restores


def train_mesh_cases() -> list:
    """The cases of the ``train-mesh`` suite, in the order the ranks run
    them. Each is a dict: ``label``, ``arch``, the (data, model) or (pod,
    data, model) ``shape``, the global batch ``b``, the config's ``fsdp``, ``remat`` and
    expert count (``experts``, None: the smoke config's), AdamW's ``clip``,
    and ``ref``: ``"mesh"`` when the reference's jitted mesh step is the
    target, ``"one"`` when its one-device step is (an MoE whose experts
    split over more than one ``model`` rank, where the reference's mesh
    gradient is not its loss's gradient: ROADMAP §3)."""
    cases = []

    def add(arch, shape, ref="mesh", b=TRAIN_MESH_BATCH, fsdp=False, remat=False,
            experts=None, clip=1.0, tag=""):
        label = f"{mesh_tag(shape)}/{arch}" + "".join(
            f"/{t}" for t, on in (("fsdp", fsdp), ("remat", remat),
                                  (f"e{experts}", experts), (f"b{b}", b != TRAIN_MESH_BATCH),
                                  (tag, tag)) if on)
        cases.append(dict(label=label, arch=arch, shape=shape, ref=ref, b=b, fsdp=fsdp,
                          remat=remat, experts=experts, clip=clip))

    add("granite-3-2b", (8, 1))
    add("granite-3-2b", (2, 4))
    add("stablelm-12b", (2, 4), fsdp=True, remat=True)
    add("stablelm-12b", (8, 1), fsdp=True)
    add("qwen2-vl-72b", (2, 4), fsdp=True)
    add("seamless-m4t-medium", (4, 2))
    add("zamba2-1.2b", (4, 2))
    # 4 experts do not divide over 8 model ranks: the one-device MoE on
    # every rank, in the reference too; 8 do, and split
    add("granite-moe-1b-a400m", (1, 8))
    add("granite-moe-1b-a400m", (1, 8), ref="one", experts=8)
    add("granite-moe-1b-a400m", (2, 4), ref="one")
    add("deepseek-v2-236b", (2, 4), ref="one", fsdp=True)
    # 2 rows a microbatch on data 4: replicated; the MoE still splits its
    # 48 tokens over data (12 a rank)
    add("stablelm-12b", (4, 2), b=4, fsdp=True)
    add("granite-moe-1b-a400m", (4, 2), b=4, ref="one")
    add("deepseek-v2-236b", (2, 4), ref="one", fsdp=True, clip=TRAIN_MESH_CLIP, tag="clip")
    # (pod, data, model): rows over pod and data, FSDP over data only, its
    # gradients reduce-scattered over data and summed over pod; the experts
    # split over model
    add("stablelm-12b", (2, 2, 2), fsdp=True, remat=True)
    add("granite-moe-1b-a400m", (2, 2, 2), ref="one")
    return cases


def train_mesh_config(case: dict, smoke_config: Callable):
    """The case's float32 config from ``smoke_config`` (either package's)."""
    import dataclasses
    cfg = dataclasses.replace(smoke_config(case["arch"]), dtype="float32",
                              fsdp=case["fsdp"], remat=case["remat"])
    if case["experts"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               n_experts=case["experts"]))
    return cfg


def train_mesh_batches(cfg, b: int, seed: int, n: int = TRAIN_MESH_STEPS) -> list:
    """``n`` batches of ``b`` x ``TRAIN_MESH_SEQ`` tokens and labels (a
    fifth -1), with the family's ``enc_embeds`` [b, 7, D] or ``pos3``, as
    numpy arrays, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = TRAIN_MESH_SEQ
        bt = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
        labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        labels[rng.random((b, s)) < 0.2] = -1
        bt["labels"] = labels
        if cfg.kind == "encdec":
            bt["enc_embeds"] = rng.standard_normal((b, 7, cfg.d_model)).astype(np.float32)
        if cfg.attn == "mrope":
            bt["pos3"] = rng.integers(0, 4 * s, (3, b, s)).astype(np.int32)
        out.append(bt)
    return out


def train_mesh_inputs(case: dict, cfg) -> dict:
    """The case's whole float32 params (``seeded_lm_params``) and batches."""
    import zlib
    from repro_torch.models import lm
    seed = zlib.crc32(case["label"].encode())
    return {"params": seeded_lm_params(lm.param_shapes(cfg), seed % 1000),
            "batches": train_mesh_batches(cfg, case["b"], seed)}


def compress_inputs(ways: int = 8) -> tuple:
    """Each rank's gradient and error-feedback trees for ``compressed_psum``:
    rank r's gradient is scaled by 1 + r, so the ranks' int8 scales differ."""
    rng = np.random.default_rng(5)
    g = {"w": np.stack([rng.standard_normal((6, 10)).astype(np.float32) * (1 + r)
                        for r in range(ways)]),
         "b": np.stack([rng.standard_normal((10,)).astype(np.float32) * (1 + r) / 4
                        for r in range(ways)])}
    err = {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32) for k, v in g.items()}
    return g, err


def flat_state(params, mu=None, nu=None) -> dict:
    """``params`` (and the moments) flattened to ``params/blocks/wq``-style
    keys, float32 numpy."""
    return {f"{name}/{k}": v.detach().float().cpu().numpy()
            for name, tree in (("params", params), ("mu", mu), ("nu", nu)) if tree is not None
            for k, v in flat_tree(tree).items()}


def _assert_trees_close(got: dict, want: dict, label: str, tol: float = TRAIN_MESH_TOL):
    """Two ``flat_state`` dicts: every leaf within ``tol`` of its own largest
    |value| (and relatively); returns the worst |err| / max|value|."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: leaves differ {sorted(set(got) ^ set(want))}")
    worst = 0.0
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol * scale,
                                   err_msg=f"{label} {k}")
        worst = max(worst, float(np.abs(got[k] - w).max()) / scale)
    return worst


def _train_steps(cfg, params, case, batches, mesh=None):
    """``len(batches)`` steps of ``make_train_step`` (AdamW lr 1e-2, eps
    1e-3, the case's clip; microbatches 2) from ``params`` (this rank's
    placement on ``mesh``); returns (params, state, losses, drops)."""
    import torch
    from repro_torch.models import layers as L, lm
    from repro_torch.train.optim import AdamW
    opt = AdamW(lr=TRAIN_MESH_LR, eps=TRAIN_MESH_EPS, grad_clip=case["clip"])
    state = opt.init(params)
    step = lm.make_train_step(cfg, opt, microbatches=TRAIN_MESH_MICRO, mesh=mesh)
    losses = []
    with L.count_drops() as drops:
        for b in batches:
            params, state, m = step(params, state, {k: torch.from_numpy(v)
                                                    for k, v in b.items()})
            losses.append(float(m["loss"]))
    return params, state, losses, int(sum(int(d) for d in drops))


def _train_mesh_case(case: dict, mesh, say_line: Callable) -> dict:
    """One case on this rank: the steps on ``mesh`` from the placed params;
    then rank 0 runs them on one device (whole params) and holds the
    mesh's losses and gathered params and moments to its at
    ``TRAIN_MESH_TOL`` (every rank's loss and gathered state are the same
    all-reduced and all-gathered values). Returns this rank's losses, drop
    count and blocks (``flat_state``)."""
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm, sharding
    from repro_torch.train.optim import global_sq_norm, tree_leaves
    cfg = train_mesh_config(case, get_smoke_config)
    inp = train_mesh_inputs(case, cfg)
    whole = convert.lm_params_from_numpy(inp["params"], device="cpu")
    specs = sharding.train_specs(cfg, lm.param_shapes(cfg), mesh)
    params, state, losses, drops = _train_steps(cfg, sharding.place(whole, specs, mesh),
                                                case, inp["batches"], mesh)
    got = flat_state(*(sharding.unplace(t, specs, mesh) for t in (params, state.mu, state.nu)))
    worst = 0.0
    if dist.get_rank() == 0:
        one_p, one_s, one_losses, _ = _train_steps(cfg, whole, case, inp["batches"])
        np.testing.assert_allclose(losses, one_losses, rtol=TRAIN_MESH_TOL,
                                   atol=TRAIN_MESH_TOL, err_msg=f"{case['label']} losses")
        worst = _assert_trees_close(got, flat_state(one_p, one_s.mu, one_s.nu), case["label"])
    rows = sharding.batch_rows(mesh, case["b"] // TRAIN_MESH_MICRO)
    note = ""
    if case["clip"] != 1.0:
        # the first microbatch: 192 tokens, dropless on one device too
        half = case["b"] // TRAIN_MESH_MICRO
        b0 = {k: torch.from_numpy(v).narrow(1 if k == "pos3" else 0, 0, half)
              for k, v in inp["batches"][0].items()}
        _, g = lm.value_and_grad(sharding.place(whole, specs, mesh), cfg, b0, mesh)
        _, g1 = lm.value_and_grad(whole, cfg, b0)
        norm = float(torch.sqrt(global_sq_norm(g, specs, mesh)))
        norm1 = float(torch.sqrt(sum(torch.sum(torch.square(x)) for x in tree_leaves(g1))))
        if not (abs(norm - norm1) <= 1e-5 * norm1 and norm1 > case["clip"]):
            raise AssertionError(f"{case['label']}: the mesh's gradient norm {norm} "
                                 f"against one device's {norm1}, clip {case['clip']}")
        note = (f"; global gradient norm {norm:.6g} == one device's {norm1:.6g} "
                f"(clip {case['clip']:g} binds)")
    split = [k for k, sp in flat_tree(specs).items() if sharding.spec_axes(sp)]
    say_line(f"{case['label']}: rows {'split over data' if rows else 'replicated'}, "
             f"{len(split)} leaves split ({', '.join(split) or 'none'}), {drops} tokens "
             f"dropped; losses {[round(x, 6) for x in losses]} == one device, params and "
             f"moments worst |err| / max = {worst:.3g} (bar {TRAIN_MESH_TOL:g}){note}: OK")
    out = {f"{case['label']}/{k}": v for k, v in
           flat_state(params, state.mu, state.nu).items()}
    out[f"{case['label']}/loss"] = np.asarray(losses, np.float64)
    out[f"{case['label']}/drops"] = np.asarray(drops)
    return out


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dicts flattened to ``blocks/wq``-style keys, in their order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _reshard_and_save(out_dir: str, say_line: Callable) -> dict:
    """``RESHARD``'s arch: 2 steps on the first mesh, a checkpoint saved from
    it (and, for the file's comparison, the same state saved whole from one
    process), ``elastic.reshard_state`` onto the second mesh, 2 more steps
    there. Returns this rank's blocks after each half."""
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mesh as mesh_util
    from repro_torch.models import lm, sharding
    from repro_torch.train import checkpoint, elastic
    from repro_torch.train.optim import AdamW
    arch, before, after = RESHARD
    case = dict(arch=arch, b=TRAIN_MESH_BATCH, fsdp=True, remat=False, experts=None,
                clip=1.0, label=f"reshard/{arch}")
    cfg = train_mesh_config(case, get_smoke_config)
    inp = train_mesh_inputs(case, cfg)
    batches = train_mesh_batches(cfg, case["b"], 99, 2 * TRAIN_MESH_STEPS)
    shapes = lm.param_shapes(cfg)
    m1 = mesh_util.make_host_mesh(*before, device="cpu")
    specs1 = sharding.train_specs(cfg, shapes, m1)
    whole = convert.lm_params_from_numpy(inp["params"], device="cpu")
    params, state, losses, _ = _train_steps(cfg, sharding.place(whole, specs1, m1), case,
                                            batches[:TRAIN_MESH_STEPS], m1)
    out = {f"reshard/before/{k}": v for k, v in flat_state(params, state.mu, state.nu).items()}
    checkpoint.save(str(Path(out_dir, "ckpt_mesh")), TRAIN_MESH_STEPS, (params, state), cfg,
                    mesh_descr="2x4", mesh=m1)
    whole_state = (sharding.unplace(params, specs1, m1),
                   state._replace(mu=sharding.unplace(state.mu, specs1, m1),
                                  nu=sharding.unplace(state.nu, specs1, m1)))
    if dist.get_rank() == 0:
        checkpoint.save(str(Path(out_dir, "ckpt_one")), TRAIN_MESH_STEPS, whole_state, cfg,
                        mesh_descr="2x4")
    m2 = mesh_util.make_host_mesh(*after, device="cpu")
    params, state = elastic.reshard_state((params, state), cfg, shapes, m2, mesh=m1)
    specs2 = sharding.train_specs(cfg, shapes, m2)
    again = sharding.place(whole_state[0], specs2, m2)
    for k, w in flat_state(params).items():
        if not np.array_equal(w, flat_state(again)[k]):
            raise AssertionError(f"reshard_state: {k} is not the new mesh's block")
    opt = AdamW(lr=TRAIN_MESH_LR, eps=TRAIN_MESH_EPS)
    step = lm.make_train_step(cfg, opt, microbatches=TRAIN_MESH_MICRO, mesh=m2)
    for b in batches[TRAIN_MESH_STEPS:]:
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    out.update({f"reshard/after/{k}": v for k, v in flat_state(params, state.mu, state.nu).items()})
    out["reshard/loss"] = np.asarray(losses, np.float64)
    say_line(f"reshard/{arch}: {TRAIN_MESH_STEPS} steps on {before[0]}x{before[1]}, checkpoint "
             f"saved from it, reshard_state onto {after[0]}x{after[1]} (each block == the new "
             f"mesh's cut of the gathered state), {TRAIN_MESH_STEPS} steps there; losses "
             f"{[round(x, 6) for x in losses]}: OK")
    return out


def _compressed_psum(mesh, rank: int) -> dict:
    import torch
    from repro_torch.models.sharding import axis_size
    from repro_torch.train import compress
    g, err = compress_inputs(axis_size(mesh, "data"))
    mine = lambda t: {k: torch.from_numpy(v[rank]) for k, v in t.items()}
    mean, new_err = compress.compressed_psum(mine(g), mine(err), mesh, "data")
    return {f"compress/{name}/{k}": v.numpy() for name, tree in (("mean", mean),
                                                                ("err", new_err))
            for k, v in tree.items()}


def train_mesh_suite(rank: int, ways: int, out_dir: Optional[str] = None) -> None:
    """The rank body of the mesh-training proof on 8 ranks: every case of
    ``train_mesh_cases`` (each held to this rank's one-device run of the
    same inputs, and the MoE's drop count), ``compressed_psum`` with
    unequal scales, the reshard and the checkpoint saved from a mesh
    (``_reshard_and_save``). Every rank writes its losses and blocks to
    ``out_dir/rank{rank}.npz``, which the tests hold to JAX."""
    if ways != 8:
        raise ValueError(f"train-mesh runs on 8 ranks, not {ways}")
    if out_dir is None:
        raise ValueError("train-mesh needs --out (the checkpoints go there)")
    results = {}

    def line(text):
        say(rank, text)

    meshes = {}
    for case in train_mesh_cases():
        if case["shape"] not in meshes:
            meshes[case["shape"]] = host_mesh(case["shape"])
        results.update(_train_mesh_case(case, meshes[case["shape"]], line))
    results.update(_compressed_psum(meshes[(8, 1)], rank))
    line(f"compressed_psum over data=8, scales 1..8 apart: sum(q) * max(scale) / n: OK")
    results.update(_reshard_and_save(out_dir, line))
    np.savez(Path(out_dir) / f"rank{rank}.npz", **results)
    say(rank, "train-mesh suite: OK")


def train_restore_suite(rank: int, ways: int, out_dir: Optional[str] = None) -> None:
    """A new group of 4 ranks (the survivors of the 8 that saved): the
    checkpoint saved from (2, 4) restored onto ``RESTORE_SHAPE``
    (``checkpoint.restore(mesh=)``), which equals ``reshard_state`` of the
    whole restored state bit for bit, then ``TRAIN_MESH_STEPS`` more
    steps. Writes ``out_dir/restore{rank}.npz``."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mesh as mesh_util
    from repro_torch.models import lm, sharding
    from repro_torch.train import checkpoint, elastic
    from repro_torch.train.optim import AdamW
    arch = RESHARD[0]
    case = dict(arch=arch, b=TRAIN_MESH_BATCH, fsdp=True, remat=False, experts=None,
                clip=1.0, label=f"reshard/{arch}")
    cfg = train_mesh_config(case, get_smoke_config)
    batches = train_mesh_batches(cfg, case["b"], 99, 2 * TRAIN_MESH_STEPS)
    shapes = lm.param_shapes(cfg)
    opt = AdamW(lr=TRAIN_MESH_LR, eps=TRAIN_MESH_EPS)
    tmpl_p = lm.init_params(cfg, 0, device="cpu")
    template = (tmpl_p, opt.init(tmpl_p))
    mesh = mesh_util.make_host_mesh(*RESTORE_SHAPE, device="cpu")
    ckpt = str(Path(out_dir, "ckpt_mesh"))
    (params, state), at = checkpoint.restore(ckpt, template, cfg=cfg, mesh=mesh)
    whole, _ = checkpoint.restore(ckpt, template, cfg=cfg)
    survivor = elastic.reshard_state(whole, cfg, shapes, mesh)
    for k, w in flat_state(survivor[0], survivor[1].mu, survivor[1].nu).items():
        if not np.array_equal(w, flat_state(params, state.mu, state.nu)[k]):
            raise AssertionError(f"restore(mesh=) and reshard_state differ at {k}")
    step = lm.make_train_step(cfg, opt, microbatches=TRAIN_MESH_MICRO, mesh=mesh)
    losses = []
    for b in batches[TRAIN_MESH_STEPS:]:
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    out = {f"restore/{k}": v for k, v in flat_state(params, state.mu, state.nu).items()}
    out["restore/loss"] = np.asarray(losses, np.float64)
    out["restore/step"] = np.asarray(int(state.step))
    np.savez(Path(out_dir) / f"restore{rank}.npz", **out)
    say(rank, f"restore on a new group of {ways} ranks as {RESTORE_SHAPE[0]}x"
              f"{RESTORE_SHAPE[1]} from step {at} == reshard_state of the whole state; "
              f"{TRAIN_MESH_STEPS} steps, losses {[round(x, 6) for x in losses]}: OK")
    say(rank, "train-restore suite: OK")


SUITES = {"partitioned": partitioned_suite, "sharded": sharded_suite, "fault": fault_suite,
          "lm-mesh": lm_mesh_suite, "train-mesh": train_mesh_suite, "tp": tp_suite}
# suites that go on in a new, smaller group once the first has ended
FOLLOW_UPS = {"train-mesh": (train_restore_suite, RESTORE_SHAPE[0] * RESTORE_SHAPE[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a mesh suite on gloo ranks on the CPU.")
    ap.add_argument("suite", choices=sorted(SUITES))
    ap.add_argument("--ways", type=int, default=8)
    ap.add_argument("--out", default=None, help="directory for rank 0's results")
    ap.add_argument("--timeout", type=float, default=GROUP_TIMEOUT_S,
                    help="the group's timeout in seconds")
    a = ap.parse_args(argv)
    if a.out is not None:
        Path(a.out).mkdir(parents=True, exist_ok=True)
    spawn_ranks(SUITES[a.suite], a.ways, args=(a.out,), timeout_s=a.timeout)
    if a.suite in FOLLOW_UPS:
        body, ways = FOLLOW_UPS[a.suite]
        spawn_ranks(body, ways, args=(a.out,), timeout_s=a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
