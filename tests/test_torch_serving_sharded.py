"""The port's sharded (batch-axis) execution path and multi-rank routing
against the JAX package's, on the CPU.

In process: the device-free half of ``tests/test_serving_sharded.py`` and
of the serving checks of ``tests/test_partitioned.py``. Decisions that only
read a mesh's shape (eligibility, the batched-vs-sharded choice, partitioned
cache keys, the server's routing of an oversized query, the executor's
routes) take a stand-in mesh of the same shape in each package and must be
equal after the backend map (``jnp``->``torch``, ``pallas``->``kernel``).
The mesh itself (``data_mesh``, its collectives, ``make_host_mesh``) is
held on a one-rank gloo group made here, with a timeout.

In a subprocess, on 8 gloo ranks (``repro_torch.testing sharded``): the
counterpart of ``tests/sharded_equality_driver.py``: on all 12 workloads
the sharded, batched and sequential realizations of a B 8 micro-batch agree
(masks and ints exact, floats 2e-5), the server shards a full group and
falls back for a remainder, and rank 0's first query equals the JAX
package's ``execute_reference`` at the ``.canonical()`` bar. A second run
(``repro_torch.testing fault``) shows that a batch failing on one rank
fails the whole run instead of being recorded and served past.
"""
import dataclasses
import datetime
import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import serving as jserving
from repro.core import cost as jcost, costed_lowering as jcl, executor as jex, ir as jir
from repro.core import mesh as jmesh
from repro.core.lowering import lower as jlower
from repro.core.plan_cache import PlanCache as JPlanCache
from repro.data import workloads as jwl
from repro.serving.batcher import MicroBatch as JMicroBatch
from repro_torch import serving as tserving
from repro_torch.core import cost, costed_lowering, ir, stage_graph
from repro_torch.core import mesh as mesh_util
from repro_torch.core import physical as ph
from repro_torch.core.lowering import lower
from repro_torch.core.plan_cache import PlanCache
from repro_torch.data import workloads as twl
from repro_torch.serving.batcher import MicroBatch
from repro_torch.testing import (GROUP_TIMEOUT_S, MESH_SCALE, WORKLOAD_TOL,
                                 assert_canonical_close, load_canonical)

from test_torch_partitioned import WAYS, launch_suite, run_suite
from test_torch_plan_cache import _MeshShape
from test_torch_rules import port_signature

NAMES = sorted(jwl.ALL_WORKLOADS)


@functools.lru_cache(maxsize=None)
def _pair(name):
    return (jwl.ALL_WORKLOADS[name](scale=MESH_SCALE),
            twl.ALL_WORKLOADS[name](scale=MESH_SCALE, device="cpu"))


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group for the duration of a test."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the mesh layer
# ---------------------------------------------------------------------------

def test_data_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_util.data_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_util.make_host_mesh(device="cpu")


def test_data_mesh_shape_and_signature_match_jax(one_rank):
    mesh = mesh_util.data_mesh(device="cpu")
    jm = jmesh.data_mesh()
    assert mesh.mesh_dim_names == tuple(jm.axis_names) == ("data",)
    assert mesh_util.batch_ways(mesh) == jmesh.batch_ways(jm) == 1
    assert mesh_util.mesh_signature(mesh) == jmesh.mesh_signature(jm) == "data=1"
    assert mesh_util.rank_of(mesh) == 0
    one = mesh_util.data_mesh(1, device="cpu")
    assert mesh_util.batch_ways(one) == 1 and not mesh_util.can_shard(one, 8)
    for bad in (2, 0):
        with pytest.raises(ValueError):
            mesh_util.data_mesh(bad, device="cpu")
    with pytest.raises(ValueError):
        mesh_util.data_mesh(1, device="cpu", axis="batch")
    assert mesh_util.group_timeout() == datetime.timedelta(seconds=60)


def test_make_host_mesh_on_one_rank(one_rank):
    mesh = mesh_util.make_host_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh_util.batch_ways(mesh) == 1 and mesh_util.mesh_signature(mesh) == "data=1xmodel=1"
    with pytest.raises(ValueError):
        mesh_util.make_host_mesh(2, 1, device="cpu")


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64, torch.float32])
def test_collectives_keep_dtype_and_values_on_one_rank(one_rank, dtype):
    mesh = mesh_util.data_mesh(device="cpu")
    x = (torch.arange(12).reshape(6, 2) % 3).to(dtype)
    g = mesh_util.all_gather_rows(x, mesh)
    assert g.dtype == dtype and torch.equal(g, x)
    s = mesh_util.all_reduce_sum(x, mesh)
    assert s.dtype == dtype and torch.equal(s, x) and s.data_ptr() != x.data_ptr()
    mesh_util.agree("same plan", mesh)
    assert mesh_util.broadcast_from_first({"k": [1]}, mesh) == {"k": [1]}


def test_collective_after_the_group_is_gone_raises(one_rank):
    mesh = mesh_util.data_mesh(device="cpu")
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_util.all_gather_rows(torch.ones(3), mesh)


def test_run_repartition_without_a_mesh_raises():
    node = ph.PRepartition(ph.PScan("t"), op="slice", ways=2, in_capacity=4,
                           out_capacity=2)
    _, tw = _pair("simple_q1")
    t = next(iter(tw.catalog.tables.values()))
    with pytest.raises(RuntimeError, match="mesh"):
        ph.run_repartition(node, t, None, None)


@pytest.mark.parametrize("ways", [1, 2, 3, 8])
def test_can_shard_policy_matches_jax(ways):
    """Eligibility is the divisibility-fitting policy AND more than one
    rank: 1-wide meshes and non-dividing batch sizes never shard."""
    assert not mesh_util.can_shard(None, 8)
    for b in range(0, 18):
        assert (mesh_util.can_shard(_MeshShape(ways), b)
                == jmesh.can_shard(_MeshShape(ways), b)), (ways, b)
        spec = mesh_util.shard_spec(_MeshShape(ways), b)
        jspec = jmesh.shard_spec(_MeshShape(ways), b)
        # PartitionSpec spells a one-axis entry as the axis name
        assert tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                     for a in spec) == tuple(jspec), (ways, b)


# ---------------------------------------------------------------------------
# the sharded realization
# ---------------------------------------------------------------------------

def _mm_plan(pkg):
    """tests/test_serving_sharded.py's one-matmul plan, annotated with the
    kernel backend, in either package."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal((8, 4)).astype(np.float32)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    if pkg == "jax":
        import jax.numpy as jnp
        from repro.mlfuncs.functions import Atom, MLFunction, MLGraph, MLNode
        from repro.mlfuncs.registry import Registry
        from repro.relational.table import Table
        t = Table.from_columns({"id": jnp.arange(8, dtype=jnp.int32), "f": jnp.asarray(f)})
        irm, be = jir, "pallas"
    else:
        from repro_torch.mlfuncs.functions import Atom, MLFunction, MLGraph, MLNode
        from repro_torch.mlfuncs.registry import Registry
        from repro_torch.relational.table import Table
        t = Table.from_columns({"id": np.arange(8, dtype=np.int32), "f": f}, device="cpu")
        irm, be = ir, "kernel"
    cat = irm.Catalog()
    cat.add("t", t)
    reg = Registry()
    reg.register(MLFunction("mm", graph=MLGraph(
        [MLNode(0, Atom("matmul", {"w": w}), (("in", 0),))], 0, 1)))
    bm = irm.BlockedMatmul(irm.Scan("t"), x_col="f", out_col="y", fn="mm")
    return irm.Plan(bm, reg, phys={bm.uid: irm.PhysConfig(mode="fused", backend=be,
                                                          n_tiles=2)}), cat


def _phys(node):
    yield node
    for c in node.children():
        yield from _phys(c)


def test_lower_sharded_backend_resolves_nodes_to_torch():
    """backend='sharded' is a plan-level realization: per node it resolves
    to the ATen path, overriding even an explicit kernel annotation, and
    lowers as the JAX package's resolves to jnp."""
    plan, cat = _mm_plan("torch")
    jplan, jcat = _mm_plan("jax")
    for costed in (False, True):
        pplan = lower(plan, cat, backend="sharded", costed=costed, profile=cost.CPU_PROFILE)
        (node,) = [n for n in _phys(pplan.root) if isinstance(n, ph.PBlockedMatmul)]
        assert node.backend == "torch" and node.mode == "fused" and node.n_tiles == 2
        want = jlower(jplan, jcat, backend="sharded", costed=costed, profile=jcost.CPU_PROFILE)
        assert pplan.signature() == port_signature(want.signature())
    assert stage_graph.PLAN_LEVEL_BACKENDS == {"sharded": "torch"}


@pytest.mark.parametrize("name", NAMES)
def test_batch_realization_choice_matches_jax(name):
    """The batched-vs-sharded choice and the costs it compares equal the
    JAX package's for every workload, batch size and mesh width."""
    jw, tw = _pair(name)
    for prior in ("CPU_PROFILE", "TPU_PROFILE", "GPU_PROFILE"):
        tp, jp = getattr(cost, prior), getattr(jcost, prior)
        for ways in (1, 2, 8):
            for b in (1, 2, 3, 8, 16):
                got = costed_lowering.choose_batch_realization(
                    tw.plan, tw.catalog, b, _MeshShape(ways), profile=tp)
                want = jcl.choose_batch_realization(jw.plan, jw.catalog, b,
                                                    _MeshShape(ways), profile=jp)
                assert got == want, (prior, ways, b)
            pp = lower(tw.plan, tw.catalog, costed=False, backend="sharded")
            jpp = jlower(jw.plan, jw.catalog, costed=False, backend="sharded")
            assert cost.batched_plan_cost(pp, tw.catalog, 8, tp, ways=ways) == pytest.approx(
                jcost.batched_plan_cost(jpp, jw.catalog, 8, jp, ways=ways), rel=1e-9)


def test_sharded_ineligible_falls_back_to_batched_entry(one_rank):
    """A 1-wide mesh (or a batch the rank count doesn't divide) reuses the
    *batched* executable under its own key, as the JAX package does; the
    fallback runs and matches the JAX package's batched results."""
    jw, tw = _pair("simple_q1")
    mesh = mesh_util.data_mesh(1, device="cpu")
    cache, jcache = PlanCache(device="cpu"), JPlanCache()
    fb = cache.get_or_compile_sharded(tw.plan, tw.catalog, 2, mesh)
    jfb = jcache.get_or_compile_sharded(jw.plan, jw.catalog, 2, jmesh.data_mesh(1))
    assert (cache.stats.misses, len(cache._cache)) == (jcache.stats.misses,
                                                       len(jcache._cache)) == (1, 1)
    assert cache.get_or_compile_batched(tw.plan, tw.catalog, 2) is fb
    assert jcache.get_or_compile_batched(jw.plan, jw.catalog, 2) is jfb
    assert cache.stats.hits == jcache.stats.hits == 1
    outs = fb(tuple(twl.rolled_instances(dict(tw.catalog.tables), 2)))
    jouts = jfb(tuple(jwl.rolled_instances(dict(jw.catalog.tables), 2)))
    for i, (o, j) in enumerate(zip(outs, jouts)):
        assert_canonical_close(j.canonical(), o.canonical(), f"instance {i}")
    with pytest.raises(ValueError):
        cache.get_or_compile_sharded(tw.plan, tw.catalog, 0, mesh)


def test_server_without_mesh_never_shards_as_jax():
    stats = []
    for srv, wl, kw in ((jserving.QueryServer(max_batch_size=2, max_wait_s=3600.0), jwl, {}),
                        (tserving.QueryServer(max_batch_size=2, max_wait_s=3600.0,
                                              device="cpu"), twl, {"device": "cpu"})):
        w = wl.ALL_WORKLOADS["simple_q1"](scale=MESH_SCALE, **kw)
        base = dict(w.catalog.tables)
        for i in range(2):
            srv.submit(w.plan, w.catalog, wl.roll_tables(base, i))
        assert srv.step() == 2
        st = srv.stats()
        stats.append((st["sharded_dispatches"], st["partitioned_dispatches"],
                      st["dispatches"]))
    assert stats[0] == stats[1] == (0, 0, 1)


# ---------------------------------------------------------------------------
# partitioned keys and the server's routing, on a mesh's shape
# ---------------------------------------------------------------------------

def _budget(tw, ways=8):
    g = stage_graph.build(tw.plan, tw.catalog, profile=cost.CPU_PROFILE, ways=ways)
    rep = cost.phys_peak_memory(g.realize(g.default_decisions()), tw.catalog, cost.CPU_PROFILE)
    part = cost.phys_peak_memory(g.realize(g.partitioned_decisions()), tw.catalog,
                                 cost.CPU_PROFILE)
    return (rep + part) / 2.0


@pytest.mark.parametrize("name", NAMES)
def test_partitioned_keys_match_jax(name):
    """``PlanCache.key(mesh=)`` under a per-device budget equals the JAX
    package's key, ``#be=part#mesh=data=8``, the ``pt*`` PartSpec tokens and
    the node-level override included."""
    jw, tw = _pair(name)
    budget = _budget(tw)
    for backend, jbackend in ((None, None), ("torch", "jnp")):
        cache = PlanCache(profile=dataclasses.replace(cost.CPU_PROFILE,
                                                      memory_budget=budget), device="cpu")
        jcache = JPlanCache(profile=dataclasses.replace(jcost.CPU_PROFILE,
                                                        memory_budget=budget))
        key = cache.key(tw.plan, tw.catalog, mesh=_MeshShape(8), backend=backend)
        jkey = jcache.key(jw.plan, jw.catalog, mesh=_MeshShape(8), backend=jbackend)
        assert key == port_signature(jkey)
        assert "#be=part#mesh=data=8" in key
        assert any(t.startswith("pt") for t in key.split("#cl=")[1].split(";"))
        assert (cache.key(tw.plan, tw.catalog, mesh=_MeshShape(1))
                == port_signature(jcache.key(jw.plan, jw.catalog, mesh=_MeshShape(1))))


def test_server_routing_matches_jax():
    """On an 8-wide mesh under a budget, the server flags and keys the
    oversized query for the partitioned executable and the query that fits
    for the plain one, as the JAX package's server does; the executor's
    routes of batches of 1, 3 and 8 agree with the reference's."""
    jw, tw = _pair("retail_q3")
    js, ts = _pair("simple_q1")
    budget = _budget(tw)
    srv = tserving.QueryServer(max_batch_size=8, max_wait_s=3600.0, mesh=_MeshShape(8),
                               memory_budget=budget, device="cpu")
    jsrv = jserving.QueryServer(max_batch_size=8, max_wait_s=3600.0, mesh=_MeshShape(8),
                                memory_budget=budget)
    big, jbig = srv.submit(tw.plan, tw.catalog), jsrv.submit(jw.plan, jw.catalog)
    small, jsmall = srv.submit(ts.plan, ts.catalog), jsrv.submit(js.plan, js.catalog)
    assert big.partitioned and jbig.partitioned and "#be=part" in big.key
    assert not small.partitioned and not jsmall.partitioned
    assert big.key == port_signature(jbig.key) and small.key == port_signature(jsmall.key)
    for n in (1, 3, 8):
        for reqs, jreqs in (([big] * n, [jbig] * n), ([small] * n, [jsmall] * n)):
            batch = MicroBatch(key=reqs[0].key, requests=reqs)
            jbatch = JMicroBatch(key=jreqs[0].key, requests=jreqs)
            want_part = jreqs[0].partitioned
            want_shard = (not want_part) and jsrv.executor._use_sharded(jbatch)
            assert srv.executor.route(batch) == (want_part, want_shard), (n, reqs[0].key)


def test_backend_override_disables_sharding_routes():
    _, tw = _pair("simple_q1")
    srv = tserving.QueryServer(max_batch_size=8, max_wait_s=3600.0, backend="torch",
                               mesh=_MeshShape(2), device="cpu")
    reqs = [srv.submit(tw.plan, tw.catalog) for _ in range(2)]
    assert srv.executor.route(MicroBatch(key=reqs[0].key, requests=reqs)) == (False, False)


def test_batcher_take_follows_another_ranks_decision():
    """``take`` pops exactly the given requests of a group, in the given
    order, and refuses ids that are not pending (diverged traffic)."""
    from repro_torch.serving import MicroBatcher, QueryRequest
    b = MicroBatcher(max_batch_size=4, max_wait_s=1.0)
    for rid in range(5):
        b.add(QueryRequest(rid=rid, plan=None, catalog=None, tables={}, key="k"))
    got = b.take("k", [3, 0])
    assert [r.rid for r in got.requests] == [3, 0] and b.pending() == 3
    with pytest.raises(RuntimeError, match="not pending"):
        b.take("k", [0])
    with pytest.raises(RuntimeError, match="not pending"):
        b.take("other", [1])
    assert [r.rid for r in b.pop_all()[0].requests] == [1, 2, 4]


# ---------------------------------------------------------------------------
# the full multi-rank proof: 8 gloo ranks in a subprocess
# ---------------------------------------------------------------------------

SHARDED_OK = ("all 12 workloads: sharded == batched == sequential", "server: OK",
              "mesh policy, fallback and keys: OK", "sharded suite: OK")


def test_sharded_equals_batched_and_sequential_all_workloads_8ranks(tmp_path):
    """8 gloo ranks: on every workload the sharded, batched and sequential
    realizations of a B 8 micro-batch agree pairwise (masks and ints
    exactly, floats 2e-5), the server picks the sharded executable for an
    eligible batch and falls back for the rest, and rank 0's first query
    equals the JAX package's ``execute_reference``."""
    out = run_suite("sharded", tmp_path)
    for line in SHARDED_OK + tuple(f"{n}: OK" for n in NAMES):
        assert line in out, line
    for name in NAMES:
        jw, _ = _pair(name)
        assert_canonical_close(jex.execute_reference(jw.plan, jw.catalog).canonical(),
                               load_canonical(tmp_path, f"{name}.sharded0"), name,
                               WORKLOAD_TOL)


def test_one_rank_fault_fails_the_run_8ranks(tmp_path):
    """8 gloo ranks serve one B 8 micro-batch whose last request is one row
    short on the last rank alone. That rank's dispatch raises out of
    ``drain`` and the run fails, well inside the group's timeout; no rank
    returns from ``drain`` (a per-batch catch on a mesh would have every
    rank record the failure and serve on)."""
    t0 = time.perf_counter()
    proc = launch_suite("fault", tmp_path)
    took = time.perf_counter() - t0
    log = f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-5000:]}"
    assert proc.returncode != 0, log
    assert f"rank {WAYS - 1}: drain raised ValueError" in proc.stdout, log
    assert "drain returned" not in proc.stdout, log
    assert took < GROUP_TIMEOUT_S, took
