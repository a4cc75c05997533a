"""The port's compiled-plan cache against the JAX package's, on the CPU.

The scenarios of ``tests/test_plan_cache.py`` run in both packages on the
same numpy-seeded inputs: hits, misses, evictions and ``traces`` (jit traces
there, executable builds here) must be equal, keys equal after the backend
map (``jnp``->``torch``, ``pallas``->``kernel``), and compiled results equal
at the ``.canonical()`` bar (5e-4). Also: the LRU machinery step for step,
eviction dropping an executable's build, an executable refusing a payload of
another schema, and the multi-device entry points keyed as the JAX
package's and raising without a process group.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as jex, ir as jir
from repro.core import plan_cache as jpc
from repro.data import workloads as jwl
from repro.mlfuncs import builders as jbuilders
from repro.mlfuncs.registry import Registry as JRegistry
from repro.relational.table import Table as JTable
from repro_torch.core import executor as tex, ir as tir
from repro_torch.core import plan_cache as tpc
from repro_torch.data import workloads as twl
from repro_torch.mlfuncs import builders as tbuilders
from repro_torch.mlfuncs.registry import Registry as TRegistry
from repro_torch.relational.table import Table as TTable
from repro_torch.testing import assert_canonical_close

from test_torch_rules import port_signature


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return {"id": np.arange(n, dtype=np.int32),
            "x": rng.uniform(0, 10, n).astype(np.float32),
            "f": rng.standard_normal((n, 8)).astype(np.float32)}


def _mini(pkg, seed=0, n=32, hidden=16, pred=3.0):
    """``tests/test_plan_cache.py::_mini_setup`` in either package, on the
    same numpy data: fresh data per seed, the same registered model."""
    if pkg == "jax":
        ir_, Table, Registry, builders = jir, JTable, JRegistry, jbuilders
        table = Table.from_columns({k: jnp.asarray(v) for k, v in _data(seed, n).items()})
    else:
        ir_, Table, Registry, builders = tir, TTable, TRegistry, tbuilders
        table = Table.from_columns(_data(seed, n), device="cpu")
    cat = ir_.Catalog()
    cat.add("t", table)
    reg = Registry()
    reg.register(builders.ffnn("m", [8, hidden, 1], seed=1))
    root = ir_.Project(
        ir_.Filter(ir_.Scan("t"), pred=ir_.Cmp(">", ir_.Col("x"), ir_.Const(pred))),
        outputs=(("score", ir_.Call("m", (ir_.Col("f"),))),),
        keep=("id",))
    return ir_.Plan(root, reg), cat


def _caches():
    return jpc.PlanCache(), tpc.PlanCache(device="cpu")


def _counts(cache):
    return (cache.stats.hits, cache.stats.misses, cache.stats.evictions,
            cache.traces)


def _both(fn):
    """Run ``fn(pkg, cache)`` on a fresh cache of each package; returns the
    two results and asserts equal counts."""
    jc, tc = _caches()
    jout, tout = fn("jax", jc), fn("torch", tc)
    assert _counts(tc) == _counts(jc)
    return jout, tout, jc, tc


def test_repeated_identical_query_hits_without_recapture():
    def scenario(pkg, cache):
        plan1, cat1 = _mini(pkg, seed=0)
        fn1 = cache.get_or_compile(plan1, cat1)
        fn1(dict(cat1.tables))
        assert cache.stats.misses == 1 and cache.traces == 1
        plan2, cat2 = _mini(pkg, seed=7)
        fn2 = cache.get_or_compile(plan2, cat2)
        out2 = fn2(dict(cat2.tables))
        assert cache.stats.hits == 1 and cache.traces == 1 and fn2 is fn1
        return out2.canonical(), cache.key(plan2, cat2)

    (jout, jkey), (tout, tkey), _, _ = _both(scenario)
    assert tkey == port_signature(jkey)
    assert_canonical_close(jout, tout, "compiled on fresh data")
    # and it computed the fresh data, as the port's own execute does
    plan2, cat2 = _mini("torch", seed=7)
    assert_canonical_close(tex.execute(plan2, cat2, device="cpu").canonical(), tout,
                           "compiled vs execute")


def test_different_structure_or_schema_misses():
    def scenario(pkg, cache):
        plan, cat = _mini(pkg)
        keys = [cache.key(plan, cat)]
        cache.get_or_compile(plan, cat)
        other, _ = _mini(pkg, pred=5.0)        # different predicate constant
        cache.get_or_compile(other, cat)
        _, cat2 = _mini(pkg, n=64)             # different capacity
        cache.get_or_compile(plan, cat2)
        wider, _ = _mini(pkg, hidden=32)       # same fn name, wider hidden
        cache.get_or_compile(wider, cat)
        keys += [cache.key(other, cat), cache.key(plan, cat2), cache.key(wider, cat)]
        assert cache.stats.misses == 4 and len(set(keys)) == 4
        return keys, None

    (jkeys, _), (tkeys, _), _, _ = _both(scenario)
    assert tkeys == [port_signature(k) for k in jkeys]
    assert tpc.schema_signature(_mini("torch")[1]) == \
        jpc.schema_signature(_mini("jax")[1])


def test_unscanned_catalog_table_does_not_over_key():
    def scenario(pkg, cache):
        plan, cat = _mini(pkg, seed=0)
        fn1 = cache.get_or_compile(plan, cat)
        fn1(dict(cat.tables))
        plan2, cat2 = _mini(pkg, seed=3)
        ks = np.arange(5, dtype=np.int32)
        cat2.add("unrelated", JTable.from_columns({"k": jnp.asarray(ks)}) if pkg == "jax"
                 else TTable.from_columns({"k": ks}, device="cpu"))
        sig = (jpc if pkg == "jax" else tpc).schema_signature
        assert sig(cat) != sig(cat2)
        assert cache.key(plan, cat) == cache.key(plan2, cat2)
        fn2 = cache.get_or_compile(plan2, cat2)
        fn2(dict(cat2.tables))
        assert fn2 is fn1 and cache.traces == 1 and len(cache._cache) == 1
        assert cache.get_or_compile(plan2, cat) is fn1
        _, cat_big = _mini(pkg, n=64)
        cache.get_or_compile(plan, cat_big)
        return sig(cat2), None

    (jsig, _), (tsig, _), jc, _ = _both(scenario)
    assert tsig == jsig and jc.stats.misses == 2


def test_compile_plan_goes_through_cache():
    def scenario(pkg, cache):
        plan, cat = _mini(pkg)
        ex = jex if pkg == "jax" else tex
        a = ex.compile_plan(plan, cat, cache=cache)().canonical()
        b = ex.compile_plan(plan, cat, cache=cache)().canonical()
        np.testing.assert_allclose(a["score"], b["score"])
        return a, None

    (ja, _), (ta, _), jc, _ = _both(scenario)
    assert jc.stats.hits == 1 and jc.traces == 1
    assert_canonical_close(ja, ta, "compile_plan")


@pytest.mark.parametrize("name", ["analytics_q1", "rec_q3", "retail_q2"])
def test_compiled_workload_keys_and_results_match_jax(name):
    """The compiled executable of a workload: one key, one build, and the
    JAX compiled result at the .canonical() bar, also on a rolled instance."""
    jw = jwl.ALL_WORKLOADS[name](scale=0.25)
    tw = twl.ALL_WORKLOADS[name](scale=0.25, device="cpu")
    jc, tc = _caches()
    assert tc.key(tw.plan, tw.catalog) == port_signature(jc.key(jw.plan, jw.catalog))
    jrun = jc.get_or_compile(jw.plan, jw.catalog)
    trun = tc.get_or_compile(tw.plan, tw.catalog)
    for shift in (0, 5):
        jout = jrun(jwl.roll_tables(dict(jw.catalog.tables), shift)).canonical()
        tout = trun(twl.roll_tables(dict(tw.catalog.tables), shift)).canonical()
        assert_canonical_close(jout, tout, f"{name} shift {shift}")
    assert _counts(tc) == _counts(jc) == (0, 1, 0, 1)


# ---------------------------------------------------------------------------
# LRU machinery: the same operations give the same contents and counts
# ---------------------------------------------------------------------------

LRU_SCRIPTS = {
    "bounds": (2, [("put", "a", 1), ("put", "b", 2), ("get", "a"), ("put", "c", 3),
                   ("get", "b")]),
    "interleaved": (3, [("put", "a", 1), ("put", "b", 2), ("put", "c", 3), ("get", "a"),
                        ("put", "b", 20), ("put", "d", 4), ("get", "c"), ("put", "e", 5),
                        ("get", "b")]),
    "clear": (4, [("put", "a", 1), ("get", "a"), ("get", "zz"), ("clear",), ("get", "a"),
                  ("put", "b", 2), ("get", "b")]),
    "maxsize_one": (1, [("put", "a", 1), ("put", "b", 2), ("put", "b", 3), ("get", "b")]),
    "maxsize_clamped": (0, [("put", "a", 1), ("put", "b", 2), ("get", "a")]),
}


@pytest.mark.parametrize("script", sorted(LRU_SCRIPTS))
def test_lru_cache_matches_jax(script):
    size, ops = LRU_SCRIPTS[script]

    def play(cls):
        c, trace = cls(maxsize=size), []
        for op, *args in ops:
            trace.append(getattr(c, op)(*args))
            trace.append((len(c), sorted(c._data), c.stats.as_dict()))
        return trace, c.maxsize

    assert play(tpc.LRUCache) == play(jpc.LRUCache)


def test_eviction_drops_the_build_and_calls_rebuild():
    """An evicted executable is released (its graph and pool, on the card);
    a caller still holding it rebuilds at its next call."""
    cache = tpc.PlanCache(maxsize=1, device="cpu")
    plan, cat = _mini("torch")
    fn = cache.get_or_compile(plan, cat)
    fn(dict(cat.tables))
    assert fn.built and cache.traces == 1
    other, _ = _mini("torch", pred=5.0)
    cache.get_or_compile(other, cat)
    assert cache.stats.evictions == 1 and not fn.built and fn.pool_bytes == 0
    fn(dict(cat.tables))
    assert fn.built and cache.traces == 2
    evicted = []
    lru = tpc.LRUCache(maxsize=1, on_evict=evicted.append)
    lru.put("a", 1)
    lru.put("b", 2)
    assert evicted == [1] and lru.stats.evictions == 1


def test_executable_refuses_another_schema():
    cache = tpc.PlanCache(device="cpu")
    plan, cat = _mini("torch")
    fn = cache.get_or_compile(plan, cat)
    fn(dict(cat.tables))
    _, small = _mini("torch", n=7)
    with pytest.raises(ValueError, match="shape or dtype"):
        fn(dict(small.tables))
    t = cat.tables["t"]
    as_f64 = TTable(columns=dict(t.columns, x=t["x"].double()), valid=t.valid)
    with pytest.raises(ValueError, match="shape or dtype"):
        fn({"t": as_f64})
    # each refusal counts, as a jax.jit retrace would; the build stays
    assert cache.traces == 3 and fn.built
    assert fn(dict(cat.tables)).capacity == 32 and cache.traces == 3


class _MeshShape:
    """A stand-in for an n-rank 1-D mesh in either package: its shape."""
    mesh_dim_names = axis_names = ("data",)

    def __init__(self, n):
        self.n, self.shape = n, {"data": n}

    def size(self, dim=None):
        return self.n


def test_multi_device_entry_points_raise():
    """The multi-device entries key and build as the JAX package's on an
    8-wide mesh (``#be=part#mesh=data=8``, ``#be=sharded#vmap=8#mesh=``)
    and fall back to the plain entries where they must; run without a
    process group, a multi-rank executable raises."""
    jcache, cache = _caches()
    jplan, jcat = _mini("jax")
    plan, cat = _mini("torch")
    eight, one = _MeshShape(8), _MeshShape(1)
    for mesh in (eight, one):
        assert cache.key(plan, cat, mesh=mesh) == port_signature(
            jcache.key(jplan, jcat, mesh=mesh))
    assert "#be=part#mesh=data=8" in cache.key(plan, cat, mesh=eight)
    assert cache.get_or_compile_partitioned(plan, cat, one) is cache.get_or_compile(plan, cat)
    assert (cache.get_or_compile_sharded(plan, cat, 3, eight)
            is cache.get_or_compile_batched(plan, cat, 3))
    sharded = cache.get_or_compile_sharded(plan, cat, 8, eight)
    jcache.get_or_compile_sharded(jplan, jcat, 8, eight)
    (key,) = [k for k in cache._cache._data if "#be=sharded" in k]
    assert [key] == [port_signature(k) for k in jcache._cache._data if "#be=sharded" in k]
    assert key.endswith("#vmap=8#mesh=data=8")
    with pytest.raises(RuntimeError, match="process group"):
        sharded([dict(cat.tables)] * 8)
    # partitioning does not lower this plan's peak: both oracles keep it
    # replicated, and the partitioned entry is the plain one
    assert cache.get_or_compile_partitioned(plan, cat, eight) is cache.get_or_compile(plan, cat)
    assert (jcache.get_or_compile_partitioned(jplan, jcat, eight)
            is jcache.get_or_compile(jplan, jcat))


def test_cache_device_and_profile():
    """The global cache resolves no device at import; a cache's profile is
    its own copy of the device's default profile."""
    from repro_torch.core import cost
    assert tpc.GLOBAL_PLAN_CACHE._device is None
    cache = tpc.PlanCache(device="cpu")
    assert cache.device == torch.device("cpu")
    assert cache.profile == cost.default_profile("cpu")
    assert cache.profile is not cost.default_profile("cpu")
    plan, cat = _mini("torch")
    assert cache(plan, cat).device == torch.device("cpu")
