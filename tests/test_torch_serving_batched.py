"""Batched dispatch in the port against sequential dispatch and the JAX
package, on the CPU.

Stacking N parameterized instances of a query and running the vmapped
cached executable must give the results of N sequential dispatches (the
reference's bar, rtol=atol=2e-5, masks exact) on all 12 workloads at scale
0.25 with B=3, with no op on vmap's per-example fallback; the sequential and
the batched results equal the JAX package's compiled and batched
executables at the ``.canonical()`` bar (5e-4). The JAX side runs once per
workload (a module-level memo). The engine kernels' custom operators keep
their plain versions under vmap on the CPU, each held against a Python loop
of its plain version; the kernel plans of three workloads run batched too.
Also ported from ``tests/test_serving_batched.py``: the 'relational'
realizations, per-batch-size caching, the batch-size guard, payload
restriction to scanned tables, and stack/unstack.
"""
import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as jir
from repro.core import plan_cache as jpc
from repro.data import workloads as jwl
from repro.mlfuncs import builders as jbuilders
from repro.mlfuncs import functions as jfunctions
from repro.mlfuncs.registry import Registry as JRegistry
from repro.relational.table import Table as JTable
from repro_torch.core import ir as tir
from repro_torch.core import plan_cache as tpc
from repro_torch.core.rules import kernel_plan
from repro_torch.data import workloads as twl
from repro_torch.kernels.block_matmul import ops as bm, ref as bm_ref
from repro_torch.kernels.decision_forest import ops as df, ref as df_ref
from repro_torch.kernels.fused_dense import ops as fd, ref as fd_ref
from repro_torch.mlfuncs import builders as tbuilders
from repro_torch.mlfuncs import functions as tfunctions
from repro_torch.mlfuncs.registry import Registry as TRegistry
from repro_torch.relational.table import Table as TTable
from repro_torch.testing import assert_canonical_close

SCALE = 0.25
BATCH = 3
NAMES = sorted(jwl.ALL_WORKLOADS)
FALLBACK = "performance drop"  # vmap's warning when an op has no batching rule


@pytest.fixture(autouse=True)
def _fallback_warnings():
    prev = torch._C._functorch._set_vmap_fallback_warning_enabled
    prev(True)
    yield
    prev(False)


def _run(cache, plan, catalog, tabs, batch):
    """Sequential dispatches of ``tabs`` and one batched dispatch; the
    fallback warnings the batched one raised."""
    run = cache.get_or_compile(plan, catalog)
    seq = [run(t) for t in tabs]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        outs = cache.get_or_compile_batched(plan, catalog, batch)(tuple(tabs))
    return seq, outs, sorted({str(r.message)[:120] for r in rec if FALLBACK in str(r.message)})


@functools.lru_cache(maxsize=None)
def _jax(name):
    w = jwl.ALL_WORKLOADS[name](scale=SCALE)
    cache = jpc.PlanCache()
    tabs = jwl.rolled_instances(dict(w.catalog.tables), BATCH)
    seq, outs, _ = _run(cache, w.plan, w.catalog, tabs, BATCH)
    return ([s.canonical() for s in seq], [o.canonical() for o in outs], cache.traces)


@functools.lru_cache(maxsize=None)
def _port(name, kernels=False):
    w = twl.ALL_WORKLOADS[name](scale=SCALE, device="cpu")
    plan = kernel_plan(w.plan, w.catalog) if kernels else w.plan
    cache = tpc.PlanCache(device="cpu")
    tabs = twl.rolled_instances(dict(w.catalog.tables), BATCH)
    return _run(cache, plan, w.catalog, tabs, BATCH) + (cache.traces,)


def _assert_batched_equals_sequential(seq, outs, rtol=2e-5, atol=2e-5):
    assert len(outs) == len(seq)
    for s, o in zip(seq, outs):
        assert set(o.columns) == set(s.columns)
        np.testing.assert_array_equal(np.asarray(o.valid), np.asarray(s.valid))
        for k in s.columns:
            np.testing.assert_allclose(np.asarray(o[k]), np.asarray(s[k]),
                                       rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_batched_equals_sequential_all_workloads(name):
    seq, outs, fallback, traces = _port(name)
    _assert_batched_equals_sequential(seq, outs)
    assert fallback == []
    assert traces == _jax(name)[2] == 2  # the sequential and the vmapped one


@pytest.mark.parametrize("name", NAMES)
def test_compiled_and_batched_match_jax(name):
    jseq, jouts, _ = _jax(name)
    seq, outs, _, _ = _port(name)
    for i in range(BATCH):
        assert_canonical_close(jseq[i], seq[i].canonical(), f"{name} compiled {i}")
        assert_canonical_close(jouts[i], outs[i].canonical(), f"{name} batched {i}")


@pytest.mark.parametrize("name", ["analytics_q1", "rec_q3", "simple_q2"])
def test_batched_kernel_plans(name):
    """The kernel plan (R3-1/R3-2 fused on the kernel, R4-2, R4-1-fuse): the
    engine kernels' custom operators under vmap, with no fallback, equal
    to sequential and to the JAX batched results."""
    seq, outs, fallback, traces = _port(name, kernels=True)
    _assert_batched_equals_sequential(seq, outs)
    assert fallback == [] and traces == 2
    for i, jout in enumerate(_jax(name)[1]):
        assert_canonical_close(jout, outs[i].canonical(), f"{name} kernel batched {i}")


def _relational(pkg):
    rng = np.random.default_rng(0)
    n = 16
    f = rng.standard_normal((n, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 48)) / 5).astype(np.float32)
    if pkg == "jax":
        ir_, Reg, builders, fns, be = jir, JRegistry, jbuilders, jfunctions, "jnp"
        t = JTable.from_columns({"id": jnp.arange(n, dtype=jnp.int32), "f": jnp.asarray(f)})
    else:
        ir_, Reg, builders, fns, be = tir, TRegistry, tbuilders, tfunctions, "torch"
        t = TTable.from_columns({"id": np.arange(n, dtype=np.int32), "f": f}, device="cpu")
    cat = ir_.Catalog()
    cat.add("t", t)
    reg = Reg()
    reg.register(fns.MLFunction("mm", graph=fns.MLGraph(
        [fns.MLNode(0, fns.Atom("matmul", {"w": w}), (("in", 0),))], 0, 1)))
    reg.register(builders.decision_forest("df", n_trees=8, depth=4, n_features=24, seed=2))
    bmn = ir_.BlockedMatmul(ir_.Scan("t"), x_col="f", out_col="y", fn="mm")
    fr = ir_.ForestRelational(bmn, x_col="f", out_col="vote", fn="df", keep=("id", "y"))
    plan = ir_.Plan(fr, reg, phys={
        bmn.uid: ir_.PhysConfig(mode="relational", backend=be, n_tiles=3),
        fr.uid: ir_.PhysConfig(mode="relational", backend=be)})
    wl = jwl if pkg == "jax" else twl
    cache = jpc.PlanCache() if pkg == "jax" else tpc.PlanCache(device="cpu")
    return _run(cache, plan, cat, wl.rolled_instances(dict(cat.tables), BATCH), BATCH) \
        + (cache.traces,)


def test_batched_relational_realizations():
    """The literal tile/tree-relation pipelines (mode='relational') stream
    Table cross joins in Python loops; they vmap like everything else."""
    seq, outs, fallback, traces = _relational("torch")
    _assert_batched_equals_sequential(seq, outs, rtol=1e-5, atol=1e-5)
    jseq, jouts, _, jtraces = _relational("jax")
    assert fallback == [] and traces == jtraces == 2
    for j, t in zip(jouts, outs):
        assert_canonical_close(j.canonical(), t.canonical(), "relational batched")


def _per_batch_size(pkg):
    wl, cache = ((jwl, jpc.PlanCache()) if pkg == "jax"
                 else (twl, tpc.PlanCache(device="cpu")))
    w = wl.ALL_WORKLOADS["simple_q1"](scale=SCALE, **({} if pkg == "jax" else {"device": "cpu"}))
    f2 = cache.get_or_compile_batched(w.plan, w.catalog, 2)
    same = cache.get_or_compile_batched(w.plan, w.catalog, 2) is f2
    f3 = cache.get_or_compile_batched(w.plan, w.catalog, 3)
    f1 = cache.get_or_compile(w.plan, w.catalog)
    return (same, f3 is not f2, f1 is not f2, cache.stats.hits, cache.stats.misses,
            cache.traces)


def test_batched_executable_is_cached_per_batch_size():
    assert _per_batch_size("torch") == _per_batch_size("jax") == (True, True, True, 1, 3, 0)


def test_batched_executable_rejects_wrong_batch_size():
    w = twl.ALL_WORKLOADS["simple_q1"](scale=SCALE, device="cpu")
    cache = tpc.PlanCache(device="cpu")
    tabs = twl.rolled_instances(dict(w.catalog.tables), 3)
    run_b = cache.get_or_compile_batched(w.plan, w.catalog, 3)
    with pytest.raises(ValueError, match="batch_size"):
        run_b(tuple(tabs[:2]))
    with pytest.raises(ValueError):
        cache.get_or_compile_batched(w.plan, w.catalog, 0)
    assert cache.traces == 0
    assert cache.key(w.plan, w.catalog) + "#vmap=3" in cache._cache


def _full_and_restricted(pkg):
    wl, cache = ((jwl, jpc.PlanCache()) if pkg == "jax"
                 else (twl, tpc.PlanCache(device="cpu")))
    w = wl.ALL_WORKLOADS["simple_q1"](scale=SCALE, **({} if pkg == "jax" else {"device": "cpu"}))
    names = (jpc if pkg == "jax" else tpc).scan_table_names(w.plan)
    fn = cache.get_or_compile(w.plan, w.catalog)
    fn(dict(w.catalog.tables))
    fn({k: w.catalog.tables[k] for k in names})
    return len(names) < len(w.catalog.tables), cache.traces


def test_full_and_restricted_table_dicts_share_one_trace():
    assert _full_and_restricted("torch") == _full_and_restricted("jax") == (True, 1)


def test_stack_unstack_roundtrip():
    w = twl.ALL_WORKLOADS["simple_q1"](scale=SCALE, device="cpu")
    tabs = twl.rolled_instances(dict(w.catalog.tables), 2)
    stacked = tpc.stack_tables(tabs)
    for table in stacked.values():
        assert table.valid.shape[0] == 2
        assert all(col.shape[0] == 2 for col in table.columns.values())
    for i, orig in enumerate(tabs):
        for k in orig:
            back = tpc.unstack_table(stacked[k], i)
            assert torch.equal(back.valid, orig[k].valid)
            assert all(torch.equal(back[c], orig[k][c]) for c in orig[k].columns)
    with pytest.raises(ValueError):
        tpc.stack_tables([])


# ---------------------------------------------------------------------------
# the engine kernels' batching rules, against a loop of their plain versions
# ---------------------------------------------------------------------------

def _x(rng, shape):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))


def _vmapped(fn, x, in_dim):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = torch.func.vmap(fn, in_dims=in_dim)(x)
    assert not [r for r in rec if FALLBACK in str(r.message)]
    return out


@pytest.mark.parametrize("in_dim", [0, 1])
def test_block_matmul_vmap_rule(in_dim):
    rng = np.random.default_rng(0)
    x, w = _x(rng, (4, 5, 24) if in_dim == 0 else (5, 4, 24)), _x(rng, (24, 40))
    out = _vmapped(lambda xi: bm.block_matmul(xi, w, 3), x, in_dim)
    loop = torch.stack([bm_ref.block_matmul(xi, w, 3) for xi in x.unbind(in_dim)])
    torch.testing.assert_close(out, loop, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="batched"):
        torch.func.vmap(lambda wi: bm.block_matmul(x[0], wi, 3))(torch.stack([w, w]))


@pytest.mark.parametrize("act", ["relu", "gelu", "identity"])
def test_fused_dense_vmap_rule(act):
    rng = np.random.default_rng(1)
    x, w, b = _x(rng, (3, 7, 16)), _x(rng, (16, 12)), _x(rng, (12,))
    out = _vmapped(lambda xi: fd.fused_dense(xi, w, b, act), x, 0)
    loop = torch.stack([fd_ref.fused_dense(xi, w, b, act) for xi in x])
    torch.testing.assert_close(out, loop, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="batched"):
        torch.func.vmap(lambda bi: fd.fused_dense(x[0], w, bi, act))(torch.stack([b, b]))


def test_forest_vmap_rule():
    rng = np.random.default_rng(2)
    depth, trees, d = 4, 6, 9
    x = _x(rng, (5, 11, d))
    feat = torch.as_tensor(rng.integers(0, d, (trees, 2 ** depth - 1)).astype(np.int32))
    thresh, leaf = _x(rng, (trees, 2 ** depth - 1)), _x(rng, (trees, 2 ** depth))
    out = _vmapped(lambda xi: df.forest_predict(xi, feat, thresh, leaf), x, 0)
    loop = torch.stack([df_ref.forest_predict(xi, feat, thresh, leaf) for xi in x])
    torch.testing.assert_close(out, loop, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="batched"):
        torch.func.vmap(lambda li: df.forest_predict(x[0], feat, thresh, li))(
            torch.stack([leaf, leaf]))
