"""The port's costed lowering against the JAX package's, on the CPU.

For each of the 12 workloads (scale 0.3) and three plans of it (as built;
after ``kernel_plan``, whose JAX twin applies the same configs with backend
``pallas``; and after R3-1/R3-2 with their annotations dropped, so that the
realization sites stay open), under the CPU prior and under a copy of the
TPU prior (the one prior of both packages whose kernel flag opens the
backend options), the port's ``lower_costed`` makes the JAX package's
decisions: the same decision vector, signature (backend names mapped
``jnp``->``torch``, ``pallas``->``kernel``), cost, baseline cost and
candidates scored. The chosen plans' results equal the JAX package's at the
``.canonical()`` bar. Also ported from ``tests/test_costed_lowering.py``:
tree-order defaults, the backend override, the shared oracle and both plan
levels.
"""
import dataclasses
import functools

import pytest

from repro.core import cost as jcost, costed_lowering as jcl, executor as jex
from repro.core.rules import ALL_RULES as J_RULES
from repro.data import workloads as jwl
from repro_torch.core import cost, costed_lowering, executor, ir, stage_graph
from repro_torch.core import physical as ph
from repro_torch.core.lowering import lower
from repro_torch.core.mcts import VanillaMCTS
from repro_torch.core.rules import ALL_RULES, kernel_plan
from repro_torch.data import workloads as twl
from repro_torch.testing import assert_canonical_close

from test_torch_rules import port_signature as _signature, sync_fresh_names

SCALE = 0.3
NAMES = sorted(jwl.ALL_WORKLOADS)
VARIANTS = ("plan", "kernel_plan", "open_sites")


def _jax_kernel_plan(plan, catalog):
    """``kernel_plan``'s five steps on the JAX rules (backend ``pallas``)."""
    original = frozenset(plan.registry)
    steps = ((("R3-1", "R3-2"), lambda c: c.get("fn") in original),
             (("R4-2",), lambda c: c.get("kind") == "mode"),
             (("R4-2",), lambda c: c.get("kind") == "node" and c.get("backend") == "pallas"),
             (("R4-1-fuse",), lambda c: True),
             (("R4-2",), lambda c: c.get("kind") == "atom" and c.get("backend") == "pallas"))
    for names, wanted in steps:
        while True:
            hit = next(((J_RULES[n], c) for n in names
                        for c in J_RULES[n].configs(plan, catalog) if wanted(c)), None)
            if hit is None:
                break
            plan = hit[0].apply(plan, catalog, hit[1])
    return plan


def _open_sites(plan, catalog, rules):
    """R3-1 and R3-2 on every call they reach, then no annotation: each
    BlockedMatmul / ForestRelational leaves its realization to lowering."""
    for name in ("R3-1", "R3-2"):
        while True:
            cfgs = rules[name].configs(plan, catalog)
            if not cfgs:
                break
            plan = rules[name].apply(plan, catalog, cfgs[0])
    return dataclasses.replace(plan, phys={})


@functools.lru_cache(maxsize=None)
def _plans(name):
    sync_fresh_names()  # rewrites name columns from each package's counter
    jw = jwl.ALL_WORKLOADS[name](scale=SCALE)
    tw = twl.ALL_WORKLOADS[name](scale=SCALE, device="cpu")
    plans = {"plan": (jw.plan, tw.plan),
             "kernel_plan": (_jax_kernel_plan(jw.plan, jw.catalog),
                             kernel_plan(tw.plan, tw.catalog)),
             "open_sites": (_open_sites(jw.plan, jw.catalog, J_RULES),
                            _open_sites(tw.plan, tw.catalog, ALL_RULES))}
    ref = jex.execute(jw.plan, jw.catalog).canonical()
    return jw, tw, plans, ref


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", NAMES)
def test_costed_lowering_matches_jax(name, variant):
    jw, tw, plans, ref = _plans(name)
    jplan, tplan = plans[variant]
    assert tplan.signature() == _signature(jplan.signature())
    for prior in ("CPU_PROFILE", "TPU_PROFILE"):
        jl = jcl.lower_costed(jplan, jw.catalog,
                              profile=dataclasses.replace(getattr(jcost, prior)),
                              memory_budget=jw.memory_budget)
        tl = costed_lowering.lower_costed(tplan, tw.catalog,
                                          profile=dataclasses.replace(getattr(cost, prior)),
                                          memory_budget=tw.memory_budget)
        label = f"{name}/{variant}/{prior}"
        assert tl.decisions == jl.decisions, label
        assert tl.signature == _signature(jl.signature), label
        assert tl.plan.signature() == _signature(jl.plan.signature()), label
        assert tl.candidates_scored == jl.candidates_scored, label
        for k in ("cost", "baseline_cost", "peak_memory"):
            assert getattr(tl, k) == pytest.approx(getattr(jl, k), rel=1e-9), (label, k)
        assert tl.budget_pruned == jl.budget_pruned, label
        if variant == "open_sites" and prior == "TPU_PROFILE":
            # the realization sites offer the kernel backend
            graph = stage_graph.build(tplan, tw.catalog, profile=cost.TPU_PROFILE)
            kinds = [o.backend for s in graph.sites.values() if s.kind == "realize"
                     for o in s.options]
            assert "kernel" in kinds or not any(
                isinstance(n, (ir.BlockedMatmul, ir.ForestRelational))
                for n in ir.walk(tplan.root)), label
        got = ph.run(tl.plan, dict(tw.catalog.tables)).canonical()
        assert_canonical_close(ref, got, label)
    # execute lowers by cost under the CPU prior, as the JAX package's does
    # under JAX_PLATFORMS=cpu
    assert_canonical_close(ref, executor.execute(tplan, tw.catalog, device="cpu").canonical(),
                           f"{name}/{variant}/execute")


def test_open_sites_reach_the_kernel_backend():
    """Under a kernel-capable prior some open realization site picks the
    kernel; under the CPU prior none can."""
    chosen = {"CPU_PROFILE": set(), "TPU_PROFILE": set(), "H100_PROFILE": set()}
    for name in NAMES:
        _, tw, plans, _ = _plans(name)
        for prior in chosen:
            low = costed_lowering.lower_costed(plans["open_sites"][1], tw.catalog,
                                               profile=getattr(cost, prior))
            for n in _phys_nodes(low.plan.root):
                if isinstance(n, (ph.PBlockedMatmul, ph.PForestRelational)):
                    chosen[prior].add(n.backend)
    assert chosen["CPU_PROFILE"] == {"torch"}
    assert "kernel" in chosen["TPU_PROFILE"] and "kernel" in chosen["H100_PROFILE"]


def _phys_nodes(node):
    yield node
    for c in node.children():
        yield from _phys_nodes(c)


# ---------------------------------------------------------------------------
# tests/test_costed_lowering.py, on the port
# ---------------------------------------------------------------------------

def test_costed_lowering_never_worse_and_cheaper_on_some():
    profile = cost.DeviceProfile.detect("cpu")
    cheaper = []
    for name in NAMES:
        tw = _plans(name)[1]
        c_tree = cost.plan_cost(lower(tw.plan, tw.catalog, costed=False), tw.catalog, profile)
        c_best = cost.plan_cost(lower(tw.plan, tw.catalog, profile=profile), tw.catalog, profile)
        assert c_best <= c_tree * (1 + 1e-12), name
        if c_best < c_tree * (1 - 1e-9):
            cheaper.append(name)
    assert len(cheaper) >= 2, cheaper


@pytest.mark.parametrize("name", ["rec_q1", "analytics_q1", "simple_q3"])
def test_default_decisions_reproduce_tree_order_lowering(name):
    tw = _plans(name)[1]
    g = stage_graph.build(tw.plan, tw.catalog, profile=cost.DeviceProfile.detect("cpu"))
    tree = lower(tw.plan, tw.catalog, costed=False)
    assert g.realize(g.default_decisions()).signature() == tree.signature()


def test_backend_override_wins_over_cost_choice():
    tw = _plans("analytics_q1")[1]
    cfgs = ALL_RULES["R3-2"].configs(tw.plan, tw.catalog)
    assert cfgs
    plan = ALL_RULES["R3-2"].apply(tw.plan, tw.catalog, cfgs[0])
    for be in ("torch", "kernel"):
        pplan = lower(plan, tw.catalog, backend=be, profile=cost.H100_PROFILE)
        nodes = [n for n in _phys_nodes(pplan.root)
                 if isinstance(n, (ph.PBlockedMatmul, ph.PForestRelational))]
        assert nodes and all(n.backend == be for n in nodes)


def test_mcts_and_lowering_share_the_plan_cost_oracle(monkeypatch):
    calls = {"n": 0}
    real = cost.plan_cost

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(cost, "plan_cost", counting)
    tw = _plans("rec_q1")[1]
    costed_lowering.lower_costed(tw.plan, tw.catalog)
    lowering_calls = calls["n"]
    assert lowering_calls > 1
    VanillaMCTS(tw.catalog, iterations=2, seed=0).optimize(tw.plan)
    assert calls["n"] > lowering_calls


def test_plan_cost_accepts_both_plan_levels():
    profile = cost.DeviceProfile.detect("cpu")
    for name in NAMES:
        tw = _plans(name)[1]
        c_log = cost.plan_cost(tw.plan, tw.catalog, profile)
        c_phys = cost.plan_cost(lower(tw.plan, tw.catalog, costed=False), tw.catalog, profile)
        assert c_phys == pytest.approx(c_log, rel=1e-12), name


def test_memory_budget_that_nothing_fits_falls_back_to_tree_order():
    tw = _plans("rec_q1")[1]
    low = costed_lowering.lower_costed(tw.plan, tw.catalog, memory_budget=1.0)
    assert low.budget_pruned_all and low.budget_pruned == low.candidates_scored
    assert low.plan.signature() == lower(tw.plan, tw.catalog, costed=False).signature()
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        costed_lowering.lower_costed(tw.plan, tw.catalog, ways=4)
