"""The port's serving tier against the JAX package's, on the CPU.

The scenarios of ``tests/test_serving.py`` run in both packages on the same
numpy-seeded inputs: the micro-batcher's admission policy, the server's
batching, failure paths, occupancy, waits and timebase give the same
counts and statistics, and results equal at the ``.canonical()`` bar
(5e-4). The feedback channel: ``calibrate_profile`` on identical
constructed ``SignatureExport``s gives the reference's fitted profile at
relative 1e-9, ``apply_calibration`` re-keys the same signatures, and
``warm_start_from_server`` primes the same warm start with one numpy
``embed_fn`` (``test_torch_search.structural_embedding``) and with the
learned Query2Vec (the JAX package's untrained embedder and its twin).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import cost as jcost, executor as jex, mcts as jmcts
from repro.core import planner as jplanner
from repro.data import templates as jtemplates, workloads as jwl
from repro.relational.table import Table as JTable
from repro import serving as jserving
from repro.serving import feedback as jfeedback
from repro_torch.core import cost as tcost, executor as tex, mcts as tmcts
from repro_torch.core import planner as tplanner
from repro_torch.core.plan_cache import PlanCache
from repro_torch.data import templates as ttemplates, workloads as twl
from repro_torch.relational.table import Table as TTable
from repro_torch import serving as tserving
from repro_torch.serving import feedback as tfeedback
from repro_torch.testing import assert_canonical_close

from test_torch_plan_cache import _mini
from test_torch_rules import port_signature, sync_fresh_names
from test_torch_search import learned_twins, one_torch_thread, structural_embedding  # noqa: F401

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_serving.py's bar


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TickingClock:
    def __init__(self, step=0.125):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _server(pkg, **kw):
    if pkg == "jax":
        return jserving.QueryServer(**kw)
    return tserving.QueryServer(device="cpu", **kw)


def _stats(srv):
    """Server statistics: counts and occupancy, no clock readings."""
    return dict(srv.stats())


def _bad_tables(pkg):
    cols = {"id": np.arange(7, dtype=np.int32), "x": np.zeros((7,), np.float32),
            "f": np.zeros((7, 8), np.float32)}
    if pkg == "jax":
        return {"t": JTable.from_columns({k: jnp.asarray(v) for k, v in cols.items()})}
    return {"t": TTable.from_columns(cols, device="cpu")}


# ---------------------------------------------------------------------------
# micro-batcher admission policy
# ---------------------------------------------------------------------------

def _batcher_trace(mod, max_batch_size, max_wait_s, adds, pops):
    b = mod.MicroBatcher(max_batch_size=max_batch_size, max_wait_s=max_wait_s)
    trace = []
    for rid, key, t in adds:
        b.add(mod.QueryRequest(rid=rid, plan=None, catalog=None, tables={},
                               key=key, submit_t=t))
    for now in pops:
        ready = b.pop_all() if now is None else b.pop_ready(now=now)
        trace.append([(mb.key, [r.rid for r in mb.requests]) for mb in ready])
        trace.append(b.pending())
    return trace, b.groups_formed, b.requests_admitted


BATCHER_SCRIPTS = {
    "full_group": (2, 1.0, [(0, "a", 0.0), (1, "a", 0.0)], [0.0]),
    "deadline": (8, 0.5, [(0, "a", 0.0), (1, "b", 0.3)], [0.4, 0.6, 0.9]),
    "split_oversize": (2, 10.0, [(i, "a" if i % 2 == 0 else "b", 0.0) for i in range(5)],
                       [0.0, None]),
    "drain_splits": (3, 10.0, [(i, "a", 0.1 * i) for i in range(8)], [None]),
}


@pytest.mark.parametrize("script", sorted(BATCHER_SCRIPTS))
def test_batcher_matches_jax(script):
    args = BATCHER_SCRIPTS[script]
    assert _batcher_trace(tserving, *args) == _batcher_trace(jserving, *args)
    with pytest.raises(ValueError):
        tserving.MicroBatcher(max_batch_size=0)


# ---------------------------------------------------------------------------
# query server end-to-end
# ---------------------------------------------------------------------------

def _batches_same_signature(pkg):
    clock = FakeClock()
    srv = _server(pkg, max_batch_size=4, max_wait_s=0.01, clock=clock)
    reqs = [srv.submit(*_mini(pkg, seed=s)) for s in range(6)]
    assert srv.pending() == 6 and not any(r.done for r in reqs)
    steps = [srv.step()]
    clock.t = 0.02
    steps.append(srv.step())
    sig = next(iter(srv.signatures.values()))
    return srv, reqs, (steps, [r.batch_size for r in reqs], sig.as_dict())


def test_query_server_batches_same_signature_and_results_match():
    jsrv, jreqs, jtrace = _batches_same_signature("jax")
    tsrv, treqs, ttrace = _batches_same_signature("torch")
    assert ttrace == jtrace and ttrace[0] == [4, 2]
    assert _stats(tsrv) == _stats(jsrv) and tsrv.cache.traces == 2
    assert list(tsrv.signatures) == [port_signature(k) for k in jsrv.signatures]
    for s, (jr, tr) in enumerate(zip(jreqs, treqs)):
        assert_canonical_close(jr.result.canonical(), tr.result.canonical(), f"seed {s}")
        ref = tex.execute(*_mini("torch", seed=s), device="cpu").canonical()
        np.testing.assert_allclose(tr.result.canonical()["score"], ref["score"],
                                   **SCORE_TOL)


def _singleton(pkg):
    srv = _server(pkg, max_batch_size=8, max_wait_s=100.0)
    req = srv.submit(*_mini(pkg, seed=0))
    steps = (srv.step(), srv.drain())
    return srv, req, (steps, req.done, req.batch_size, srv.cache.stats.misses)


def test_query_server_drain_and_singleton_batch():
    jsrv, jreq, jtrace = _singleton("jax")
    tsrv, treq, ttrace = _singleton("torch")
    assert ttrace == jtrace == ((0, 1), True, 1, 1)
    assert _stats(tsrv) == _stats(jsrv)
    assert_canonical_close(jreq.result.canonical(), treq.result.canonical(), "singleton")


def _distinct(pkg):
    srv = _server(pkg, max_batch_size=4, max_wait_s=0.0)
    pa, ca = _mini(pkg, seed=0)
    other, _ = _mini(pkg, seed=0, pred=5.0)
    ra, rb = srv.submit(pa, ca), srv.submit(other, ca)
    srv.drain()
    return srv, (ra.key != rb.key, len(srv.signatures), ra.batch_size, rb.batch_size)


def test_query_server_distinct_signatures_never_mix():
    jsrv, jtrace = _distinct("jax")
    tsrv, ttrace = _distinct("torch")
    assert ttrace == jtrace == (True, 2, 1, 1)
    assert _stats(tsrv) == _stats(jsrv)


def _failed_dispatch(pkg):
    srv = _server(pkg, max_batch_size=4, max_wait_s=0.0)
    plan, cat = _mini(pkg, seed=0)
    good = srv.submit(plan, cat)
    bad = srv.submit(plan, cat, _bad_tables(pkg))  # same key, wrong capacity
    srv.drain()
    first = (good.done, bad.done, good.error is not None, bad.error is not None,
             srv.failed, srv.pending(), next(iter(srv.signatures.values())).failures)
    ok = srv.submit(plan, cat)
    srv.drain()
    return srv, ok, (first, ok.done, ok.error, srv.completed)


def test_query_server_failed_dispatch_marks_requests_not_hangs():
    jsrv, jok, jtrace = _failed_dispatch("jax")
    tsrv, tok, ttrace = _failed_dispatch("torch")
    assert ttrace == jtrace == ((True, True, True, True, 2, 0, 2), True, None, 1)
    assert _stats(tsrv) == _stats(jsrv)
    assert_canonical_close(jok.result.canonical(), tok.result.canonical(), "after failure")


def _occupancy(pkg):
    clock = FakeClock()
    srv = _server(pkg, max_batch_size=2, max_wait_s=100.0, clock=clock)
    plan, cat = _mini(pkg, seed=0)
    for _ in range(3):
        srv.submit(plan, cat)
    trace = [srv.step()]
    sig = next(iter(srv.signatures.values()))
    trace.append(sig.as_dict())
    srv.drain()
    trace.append(sig.as_dict())
    return srv, trace


def test_mean_occupancy_counts_only_served_requests():
    jsrv, jtrace = _occupancy("jax")
    tsrv, ttrace = _occupancy("torch")
    assert ttrace == jtrace
    assert ttrace[1]["mean_occupancy"] == 2.0 and ttrace[2]["mean_occupancy"] == 1.5


def _occupancy_failed(pkg):
    srv = _server(pkg, max_batch_size=4, max_wait_s=0.0)
    plan, cat = _mini(pkg, seed=0)
    srv.submit(plan, cat)
    srv.submit(plan, cat, _bad_tables(pkg))
    srv.drain()
    srv.submit(plan, cat)
    srv.drain()
    sig = next(iter(srv.signatures.values()))
    return srv, (sig.requests, sig.failures, sig.served_requests, sig.dispatches,
                 sig.mean_occupancy)


def test_mean_occupancy_ignores_failed_batches():
    jsrv, jtrace = _occupancy_failed("jax")
    tsrv, ttrace = _occupancy_failed("torch")
    assert ttrace == jtrace == (3, 2, 1, 1, 1.0)
    assert _stats(tsrv) == _stats(jsrv)


def _waits(pkg, fb):
    clock = FakeClock()
    srv = _server(pkg, max_batch_size=2, max_wait_s=100.0, clock=clock)
    plan, cat = _mini(pkg, seed=0)
    srv.submit(plan, cat)
    clock.t = 0.5
    srv.submit(plan, cat)
    steps = srv.step()
    sig = next(iter(srv.signatures.values()))
    e = fb.export_signature_stats(srv)[0]
    return (steps, sig.total_wait_s, sig.as_dict()["mean_wait_s"], e.mean_wait_s,
            e.requests, e.dispatches, e.mean_occupancy)


def test_mean_wait_s_reaches_stats_and_feedback_payload():
    jtrace, ttrace = _waits("jax", jfeedback), _waits("torch", tfeedback)
    assert ttrace == jtrace
    assert ttrace[2] == pytest.approx(0.25)


def _timebase(pkg):
    clock = TickingClock()
    srv = _server(pkg, max_batch_size=2, max_wait_s=1e9, clock=clock)
    plan, cat = _mini(pkg, seed=0)
    reqs = [srv.submit(plan, cat) for _ in range(2)]
    steps = srv.step()
    sig = next(iter(srv.signatures.values()))
    return (steps, sig.dispatches, sig.total_dispatch_s,
            [(r.submit_t, r.dispatch_t, r.finish_t, r.queue_wait_s, r.latency_s)
             for r in reqs])


def test_dispatch_and_finish_share_one_timebase():
    """Both timestamps bracket the dispatch on the executor's clock: the
    ticking clock's reads line up call for call in both packages."""
    jtrace, ttrace = _timebase("jax"), _timebase("torch")
    assert ttrace == jtrace
    for submit_t, dispatch_t, finish_t, wait, lat in ttrace[3]:
        assert finish_t - dispatch_t == pytest.approx(ttrace[2])
        assert dispatch_t >= submit_t and wait == pytest.approx(dispatch_t - submit_t)


def test_server_multi_device_routes_raise():
    """On a 4-wide mesh under a budget the oversized query is keyed and
    flagged for the partitioned executable as in the JAX package; without a
    process group the server cannot agree its batches with the other ranks
    and raises."""
    from test_torch_plan_cache import _MeshShape
    mesh = _MeshShape(4)
    budget = 2e5
    jsrv = jserving.QueryServer(max_batch_size=4, max_wait_s=3600.0, mesh=mesh,
                                memory_budget=budget)
    srv = tserving.QueryServer(max_batch_size=4, max_wait_s=3600.0, mesh=mesh,
                               memory_budget=budget, device="cpu")
    assert isinstance(tserving.BatchedExecutor(PlanCache(device="cpu"), mesh=mesh).mesh,
                      _MeshShape)
    reqs = {}
    for pkg, server, wl, kw in (("jax", jsrv, jwl, {}), ("torch", srv, twl, {"device": "cpu"})):
        big = wl.ALL_WORKLOADS["retail_q3"](scale=0.25, **kw)
        small = wl.ALL_WORKLOADS["simple_q1"](scale=0.1, **kw)
        reqs[pkg] = (server.submit(big.plan, big.catalog),
                     server.submit(small.plan, small.catalog))
    (jbig, jsmall), (big, small) = reqs["jax"], reqs["torch"]
    assert big.partitioned and jbig.partitioned and not small.partitioned
    assert (big.key, small.key) == (port_signature(jbig.key), port_signature(jsmall.key))
    assert "#be=part#mesh=data=4" in big.key
    # one process and no process group: rank 0's decision cannot be shared
    with pytest.raises(RuntimeError, match="process group"):
        srv.drain()
    assert srv.pending() == 2 and srv.stats()["partitioned_dispatches"] == 0
    assert srv.cache.profile.memory_budget == budget
    assert tcost.default_profile("cpu").memory_budget is None


# ---------------------------------------------------------------------------
# feedback channel
# ---------------------------------------------------------------------------

CAL_WORKLOADS = ("simple_q1", "simple_q2", "retail_q2", "analytics_q1", "rec_q3")
# (requests, dispatches, occupancy, seconds, wait, sharded, partitioned, ways)
CAL_TRAFFIC = [(12, 3, 4.0, 2.1e-3, 1e-4, 0, 0, 0),
               (8, 8, 1.0, 4.7e-4, 0.0, 0, 0, 0),
               (30, 5, 6.0, 1.9e-2, 3e-4, 0, 0, 0),
               (9, 3, 3.0, 8.0e-3, 2e-4, 3, 0, 4),
               (4, 2, 2.0, 6.5e-2, 0.0, 0, 2, 2)]


def _exports(pkg):
    wl, fb = (jwl, jfeedback) if pkg == "jax" else (twl, tfeedback)
    out = []
    for name, (req, disp, occ, sec, wait, sh, pt, ways) in zip(CAL_WORKLOADS,
                                                                CAL_TRAFFIC):
        w = wl.ALL_WORKLOADS[name](scale=0.3, **({} if pkg == "jax" else {"device": "cpu"}))
        out.append(fb.SignatureExport(
            key=name, requests=req, dispatches=disp, mean_occupancy=occ,
            mean_dispatch_s=sec, mean_wait_s=wait, plan=w.plan, catalog=w.catalog,
            sharded_dispatches=sh, partitioned_dispatches=pt, ways=ways))
    return out


def _profile_fields(p):
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


@pytest.mark.parametrize("prior", ["cpu", "tpu"])
def test_calibrate_profile_matches_jax(prior):
    jprior = {"cpu": jcost.CPU_PROFILE, "tpu": jcost.TPU_PROFILE}[prior]
    tprior = {"cpu": tcost.CPU_PROFILE, "tpu": tcost.TPU_PROFILE}[prior]
    jfit = jfeedback.calibrate_profile(_exports("jax"), jprior)
    tfit = tfeedback.calibrate_profile(_exports("torch"), tprior)
    assert tfit.n_samples == jfit.n_samples == len(CAL_WORKLOADS)
    assert tfit.mape_before == pytest.approx(jfit.mape_before, rel=1e-9)
    assert tfit.mape_after == pytest.approx(jfit.mape_after, rel=1e-9)
    jf, tf = _profile_fields(jfit.profile), _profile_fields(tfit.profile)
    assert tf.pop("supports_kernel") == jf.pop("supports_pallas")
    for k, v in jf.items():
        if isinstance(v, float):
            assert tf[k] == pytest.approx(v, rel=1e-9), k
        else:
            assert tf[k] == v, k
    assert tfit.mape_after <= tfit.mape_before
    # an empty export list fits nothing and returns the prior
    assert tfeedback.calibrate_profile([], tprior).n_samples == 0


def _apply(pkg):
    srv = _server(pkg, max_batch_size=4, max_wait_s=0.0, clock=FakeClock())
    wl = jwl if pkg == "jax" else twl
    kw = {} if pkg == "jax" else {"device": "cpu"}
    keys_before = []
    for name in ("simple_q2", "retail_q2"):
        w = wl.ALL_WORKLOADS[name](scale=0.3, **kw)
        for i in range(3):
            keys_before.append(srv.submit(w.plan, w.catalog,
                                          wl.roll_tables(dict(w.catalog.tables), i)).key)
    srv.drain()
    exports = (jfeedback if pkg == "jax" else tfeedback).export_signature_stats(srv)
    # the measured seconds are the host's: give both packages the same ones
    for e, sec in zip(exports, (3.0e-3, 5.0e-4)):
        e.mean_dispatch_s = sec
    epoch = srv.cache.profile_epoch
    fit = (jfeedback if pkg == "jax" else tfeedback).apply_calibration(srv.cache, exports)
    keys_after = [srv.cache.key(e.plan, e.catalog) for e in exports]
    return (srv.cache.profile_epoch - epoch, fit.n_samples, keys_before,
            [e.key for e in exports], keys_after, fit.profile.op_overhead_s)


def test_apply_calibration_installs_fit_and_rekeys():
    jr, tr = _apply("jax"), _apply("torch")
    assert tr[:2] == jr[:2] == (1, 2)
    for j, t in zip(jr[2:5], tr[2:5]):
        assert t == [port_signature(k) for k in j]
    assert tr[5] == pytest.approx(jr[5], rel=1e-9)


def test_warm_start_from_server_matches_jax():
    """Server traffic of one template family primes ``ReusableMCTS`` with
    the same nodes in both packages (one numpy ``embed_fn``), and the next
    variant of the family collides with the primed root in both."""
    _check_warm_start(structural_embedding, structural_embedding)


def test_warm_start_from_server_learned_matches_jax():
    """``tests/test_serving.py``'s feedback warm start with the learned
    Query2Vec: the JAX package's ``init_embedder(0)`` and the port's twin
    under its weights prime the same store, and the next variant collides,
    replays the primed chain and gets the warm budget in both."""
    jemb, temb = learned_twins()
    tstats = _check_warm_start(jemb.embed, temb.embed)
    assert tstats["replayed"] and tstats["iterations"] == 4 and tstats["speedup"] > 1.5


def _check_warm_start(jembed, tembed):
    kw = dict(catalog_fn=None, iterations=16, warm_iterations=4, sim_threshold=0.98, seed=0)
    results = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            mcts, planner, templates, wl, fb = jmcts, jplanner, jtemplates, jwl, jfeedback
            dev, embed = {}, jembed
        else:
            mcts, planner, templates, wl, fb = tmcts, tplanner, ttemplates, twl, tfeedback
            dev, embed = {"device": "cpu"}, tembed
        srv = _server(pkg, max_batch_size=4, max_wait_s=0.0, clock=FakeClock())
        for i in range(6):
            plan, cat = templates.sample_query(1, seed=1, scale=0.3, **dev)
            srv.submit(plan, cat, wl.roll_tables(dict(cat.tables), i))
        srv.drain()
        exports = fb.export_signature_stats(srv)
        assert len(exports) == 1 and exports[0].requests == 6
        exports[0].mean_dispatch_s = 1e-3  # the host's clock: the same for both
        warm = mcts.ReusableMCTS(cost_fn_factory=lambda c, p=planner: p.analytic_cost_fn(c),
                                 embed_fn=embed, **kw)
        sync_fresh_names()
        summary = fb.warm_start_from_server(warm, exports, top_k=1)
        sync_fresh_names()
        _, stats = warm.optimize(*templates.sample_query(1, seed=2, scale=0.3, **dev))
        results[pkg] = (summary, stats)
    (js, jstats), (ts, tstats) = results["jax"], results["torch"]
    assert ts["store_nodes"] == js["store_nodes"] > 0
    assert ts["store_bytes"] == js["store_bytes"]
    (jp,), (tp,) = js["primed"], ts["primed"]
    assert tp["key"] == port_signature(jp["key"])
    assert (tp["requests"], tp["iterations"]) == (jp["requests"], jp["iterations"])
    assert tp["weight"] == pytest.approx(jp["weight"], rel=1e-9)
    assert tp["best_cost"] == pytest.approx(jp["best_cost"], rel=1e-9)
    for k in ("collision", "replayed", "iterations"):
        assert tstats[k] == jstats[k], k
    assert tstats["collision"] and tstats["best_cost"] == pytest.approx(
        jstats["best_cost"], rel=1e-9)
    return tstats
