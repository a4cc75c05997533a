"""The port's plan search against the JAX package's, on the CPU.

Under the same cost profile (the CPU prior, the one both packages detect
here), the same seeded workload makes the same choices in both packages:
``VanillaMCTS`` on rec_q1 at scale 0.4, 25 iterations, seed 0, chooses the
JAX package's plan (same signature, same ``speedup``), as do
``optimize_greedy``, ``optimize_heuristic``, ``optimize_vanilla_mcts`` on
four workloads and ``optimize_arbitrary`` on one; the
chosen plans return the JAX package's results at the ``.canonical()`` bar.
``ReusableMCTS`` gives the same collision sequence, plans and node store
over template queries in both packages, with one deterministic numpy
``embed_fn`` (``structural_embedding`` below, which embeds either package's
plans) and with the learned Query2Vec (the JAX package's
``init_embedder(0)`` and its twin carried over by
``convert.embedder_from_numpy``). Also ported from ``tests/test_mcts.py``
(the untrained port embedder's collisions and results) and
``tests/test_workloads.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import executor as jex, mcts as jmcts, optimizer as jom, planner as jplanner
from repro.data import templates as jtemplates, workloads as jwl
from repro_torch import convert
from repro_torch.core import cost, executor, ir, mcts, optimizer as om, planner
from repro_torch.data import templates, workloads as twl
from repro_torch.testing import assert_canonical_close

from test_torch_rules import port_signature as _signature, sync_fresh_names


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op threads spin when the test workers share the cores;
    one thread keeps a module's small CPU ops fast under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_EMBED_NODES = ("Scan", "Filter", "Project", "Compact", "Join", "CrossJoin",
                "Aggregate", "BlockedMatmul", "ForestRelational")
_EMBED_ATOMS = ("matmul", "bias", "act", "concat", "cossim", "dot", "dist",
                "embed", "forest", "fused_dense", "add", "mul", "sqrt", "argmin")


def structural_embedding(plan: ir.Plan, catalog: ir.Catalog) -> np.ndarray:
    """A fixed ``embed_fn`` that embeds either package's plans alike: counts
    of the plan's node kinds and of its ML functions' atom kinds, and the
    octave of the catalog's total capacity, as a unit vector. It reads only
    node class names, ``children()``, the registry's graphs and
    ``catalog.stats``."""
    v = np.zeros(len(_EMBED_NODES) + len(_EMBED_ATOMS) + 1, np.float64)
    stack = [plan.root]
    while stack:
        n = stack.pop()
        v[_EMBED_NODES.index(type(n).__name__)] += 1.0
        stack.extend(n.children())
    for fn in plan.registry:
        g = plan.registry.get(fn).graph
        for node in (g.nodes if g else ()):
            if node.atom.kind in _EMBED_ATOMS:
                v[len(_EMBED_NODES) + _EMBED_ATOMS.index(node.atom.kind)] += 1.0
    v[-1] = np.log2(1 + sum(s.capacity for s in catalog.stats.values()))
    return (v / np.linalg.norm(v)).astype(np.float32)


def learned_twins(seed=0):
    """The JAX package's untrained embedder and the port's carrying its
    weights (``convert.embedder_from_numpy``)."""
    jemb = jom.init_embedder(seed)
    tree = {p: jax.tree.map(np.asarray, getattr(jemb, p)) for p in convert.EMBEDDER_PARTS}
    return jemb, convert.embedder_from_numpy(dict(tree, one_model=False), device="cpu")


@functools.lru_cache(maxsize=None)
def _pair(name, scale):
    jw = jwl.ALL_WORKLOADS[name](scale=scale)
    return jw, twl.ALL_WORKLOADS[name](scale=scale, device="cpu")


def _cost_fns(jw, tw):
    return (jplanner.analytic_cost_fn(jw.catalog, memory_budget=jw.memory_budget),
            planner.analytic_cost_fn(tw.catalog, cost.CPU_PROFILE,
                                     memory_budget=tw.memory_budget))


def test_vanilla_mcts_matches_jax():
    jw, tw = _pair("rec_q1", 0.4)
    jfn, tfn = _cost_fns(jw, tw)
    sync_fresh_names()
    jbest, jstats = jmcts.VanillaMCTS(jw.catalog, jfn, iterations=25, seed=0).optimize(jw.plan)
    sync_fresh_names()
    best, stats = mcts.VanillaMCTS(tw.catalog, tfn, iterations=25, seed=0).optimize(tw.plan)
    assert best.signature() == _signature(jbest.signature())
    assert stats["speedup"] == pytest.approx(jstats["speedup"], rel=1e-9)
    assert stats["speedup"] > 1.5
    assert_canonical_close(jex.execute(jw.plan, jw.catalog).canonical(),
                           executor.execute(best, tw.catalog, device="cpu").canonical(),
                           "vanilla_mcts")


@pytest.mark.parametrize("name,strategy", [
    (name, strategy) for name in ("rec_q1", "retail_q2", "analytics_q1", "rec_q3")
    for strategy in ("heuristic", "greedy", "vanilla_mcts")] + [("rec_q3", "arbitrary")])
def test_strategies_match_jax(name, strategy):
    jw, tw = _pair(name, 0.3)
    jfn, tfn = _cost_fns(jw, tw)
    kw = dict(memory_budget=jw.memory_budget, iterations=15, seed=0)
    sync_fresh_names()
    jplan, jstats = jplanner.STRATEGIES[strategy](jw.plan, jw.catalog, cost_fn=jfn, **kw)
    sync_fresh_names()
    tplan, tstats = planner.STRATEGIES[strategy](tw.plan, tw.catalog, cost_fn=tfn, **kw)
    assert tplan.signature() == _signature(jplan.signature())
    assert tfn(tplan) == pytest.approx(jfn(jplan), rel=1e-9)
    assert {k: v for k, v in tstats.items() if not isinstance(v, float)} == \
        {k: v for k, v in jstats.items() if not isinstance(v, float)}
    assert_canonical_close(jex.execute(jw.plan, jw.catalog).canonical(),
                           executor.execute(tplan, tw.catalog, device="cpu").canonical(),
                           f"{name}/{strategy}")


def test_configure_action_returns_best_config():
    tw = _pair("rec_q1", 0.4)[1]
    res = mcts.configure_action(tw.plan, tw.catalog, "R4-1-split",
                                planner.analytic_cost_fn(tw.catalog))
    assert res is not None and res[1].rule == "R4-1-split"
    assert mcts.configure_action(tw.plan, tw.catalog, "R2-3",
                                 planner.analytic_cost_fn(tw.catalog)) is None


def test_analytic_cost_fn_prices_on_the_catalog_device():
    tw = _pair("simple_q1", 0.3)[1]
    fn = planner.analytic_cost_fn(tw.catalog)
    assert fn(tw.plan) == cost.plan_cost(tw.plan, tw.catalog, cost.CPU_PROFILE)
    timed_plan, stats = planner.timed(planner.optimize_none, tw.plan, tw.catalog)
    assert timed_plan is tw.plan and stats["opt_seconds"] >= 0.0
    assert set(planner.STRATEGIES) == set(jplanner.STRATEGIES)


QUERIES = [(4, 1), (4, 2), (11, 5), (11, 6), (15, 3), (15, 4), (4, 3)]


def _reusable_pair(jembed, tembed):
    kw = dict(catalog_fn=None, iterations=8, warm_iterations=3, sim_threshold=0.98, seed=0)
    return (jmcts.ReusableMCTS(embed_fn=jembed,
                               cost_fn_factory=lambda c: jplanner.analytic_cost_fn(c), **kw),
            mcts.ReusableMCTS(embed_fn=tembed,
                              cost_fn_factory=lambda c: planner.analytic_cost_fn(c), **kw))


def test_reusable_mcts_matches_jax():
    """Same collisions, iterations and chosen plans, query by query; the
    same node store; and the chosen plans' results equal the JAX
    package's."""
    _check_reusable(*_reusable_pair(structural_embedding, structural_embedding))


def test_reusable_mcts_learned_matches_jax():
    """As above with the learned Query2Vec: the JAX package's
    ``init_embedder(0)`` and the port's twin under its weights."""
    jemb, temb = learned_twins()
    _check_reusable(*_reusable_pair(jemb.embed, temb.embed))
    assert temb.cache_stats.as_dict() == jemb.cache_stats.as_dict()


def _check_reusable(jr, tr):
    seen = []
    for t, seed in QUERIES:
        jp, jc = jtemplates.sample_query(t, seed=seed, scale=0.3)
        tp, tc = templates.sample_query(t, seed=seed, scale=0.3, device="cpu")
        sync_fresh_names()
        jbest, js = jr.optimize(jp, jc)
        sync_fresh_names()
        tbest, ts = tr.optimize(tp, tc)
        for k in ("collision", "iterations", "replayed"):
            assert ts[k] == js[k], (t, seed, k)
        assert ts["speedup"] == pytest.approx(js["speedup"], rel=1e-9)
        assert tbest.signature() == _signature(jbest.signature()), (t, seed)
        seen.append(ts["collision"])
        if t == 11:
            assert_canonical_close(jex.execute(jp, jc).canonical(),
                                   executor.execute(tbest, tc, device="cpu").canonical(),
                                   f"template {t} seed {seed}")
    assert tr.collision_rate == jr.collision_rate and True in seen and False in seen
    assert tr.storage_bytes() == jr.storage_bytes() > 0
    assert len(tr.index) == len(jr.index)


def test_reusable_mcts_state_sharing():
    """Two parameter variants of one template collide in the node store
    and the second gets the warm budget (``tests/test_mcts.py``)."""
    r = mcts.ReusableMCTS(catalog_fn=None, embed_fn=structural_embedding,
                          cost_fn_factory=lambda cat: planner.analytic_cost_fn(cat),
                          iterations=8, warm_iterations=3, sim_threshold=0.98, seed=0)
    p1, c1 = templates.sample_query(4, seed=1, scale=0.3, device="cpu")
    p2, c2 = templates.sample_query(4, seed=2, scale=0.3, device="cpu")
    _, s1 = r.optimize(p1, c1)
    _, s2 = r.optimize(p2, c2)
    assert not s1["collision"] and s2["collision"]
    assert s2["iterations"] < s1["iterations"]
    assert r.collision_rate == 0.5 and r.storage_bytes() > 0


def test_node_index_is_exact_cosine_search():
    idx = mcts.NodeIndex()
    assert idx.search(np.ones(3, np.float32)) == (-1, -1.0)
    for i, v in enumerate(np.eye(3, dtype=np.float32)):
        idx.add(10 + i, v)
    nid, sim = idx.search(np.array([0.1, 0.9, 0.1], np.float32))
    assert nid == 11 and sim == pytest.approx(0.9) and len(idx) == 3


def test_reusable_mcts_state_sharing_learned():
    """``tests/test_mcts.py``'s: the port's own untrained embedder embeds two
    parameter variants of one template nearby enough to collide."""
    emb = om.init_embedder(0, device="cpu")
    r = mcts.ReusableMCTS(catalog_fn=None, embed_fn=emb.embed,
                          cost_fn_factory=lambda cat: planner.analytic_cost_fn(cat),
                          iterations=8, warm_iterations=3, sim_threshold=0.98, seed=0)
    p1, c1 = templates.sample_query(4, seed=1, scale=0.3, device="cpu")
    p2, c2 = templates.sample_query(4, seed=2, scale=0.3, device="cpu")
    _, s1 = r.optimize(p1, c1)
    _, s2 = r.optimize(p2, c2)
    assert not s1["collision"] and s2["collision"]
    assert s2["iterations"] < s1["iterations"]
    assert r.collision_rate == 0.5 and r.storage_bytes() > 0
    assert emb.cache_stats.misses > 0


def test_reusable_mcts_learned_preserves_results():
    emb = om.init_embedder(0, device="cpu")
    r = mcts.ReusableMCTS(catalog_fn=None, embed_fn=emb.embed,
                          cost_fn_factory=lambda cat: planner.analytic_cost_fn(cat),
                          iterations=10, seed=1)
    plan, cat = templates.sample_query(11, seed=5, scale=0.3, device="cpu")
    best, _ = r.optimize(plan, cat)
    assert_canonical_close(executor.execute(plan, cat, device="cpu").canonical(),
                           executor.execute(best, cat, device="cpu").canonical(),
                           "template 11 seed 5")
