"""The port's cost oracle against the JAX package's, on the CPU.

Both packages build the same seeded workloads (scale 0.3) and price them
under the same priors (CPU, TPU, A100): ``plan_cost`` of the logical plan
and of its tree-order physical plan, ``plan_peak_memory`` and
``phys_peak_memory``, ``plan_cost_breakdown`` and ``batched_plan_cost``
agree at relative 1e-9 (the same float64 formulas). Also ported from
``tests/test_cost_model.py``: compaction-placement monotonicity, kernel vs
torch pricing, batched scaling and ``fit_profile``; and ``detect`` on the
CPU and on a mocked compute capability.
"""
import dataclasses
import functools

import pytest
import torch

from repro.core import cost as jcost
from repro.core.lowering import lower as jlower
from repro.data import workloads as jwl
from repro_torch.core import cost, ir, stage_graph
from repro_torch.core.lowering import lower
from repro_torch.core.rules import ALL_RULES
from repro_torch.data import workloads as twl

SCALE = 0.3
NAMES = sorted(jwl.ALL_WORKLOADS)
PRIORS = ("CPU_PROFILE", "TPU_PROFILE", "GPU_PROFILE")
REL = 1e-9


@functools.lru_cache(maxsize=None)
def _pair(name):
    return (jwl.ALL_WORKLOADS[name](scale=SCALE),
            twl.ALL_WORKLOADS[name](scale=SCALE, device="cpu"))


def _close(a, b, label):
    assert b == pytest.approx(a, rel=REL, abs=0.0), label


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("name", NAMES)
def test_costs_match_jax(name, prior):
    jw, tw = _pair(name)
    jp, tp = getattr(jcost, prior), getattr(cost, prior)
    jtree = jlower(jw.plan, jw.catalog, costed=False)
    ttree = lower(tw.plan, tw.catalog, costed=False)
    for label, jplan, tplan in (("logical", jw.plan, tw.plan), ("tree", jtree, ttree)):
        _close(jcost.plan_cost(jplan, jw.catalog, jp),
               cost.plan_cost(tplan, tw.catalog, tp), f"{label} plan_cost")
        _close(jcost.plan_cost(jplan, jw.catalog, jp, memory_budget=jw.memory_budget),
               cost.plan_cost(tplan, tw.catalog, tp, memory_budget=tw.memory_budget),
               f"{label} plan_cost under the workload's budget")
        _close(jcost.plan_peak_memory(jplan, jw.catalog, jp),
               cost.plan_peak_memory(tplan, tw.catalog, tp), f"{label} peak memory")
        jb = dataclasses.asdict(jcost.plan_cost_breakdown(jplan, jw.catalog, jp))
        tb = dataclasses.asdict(cost.plan_cost_breakdown(tplan, tw.catalog, tp))
        assert set(jb) == set(tb)
        for k in jb:
            _close(jb[k], tb[k], f"{label} breakdown {k}")
        for batch, ways in ((1, 1), (8, 1), (8, 4)):
            _close(jcost.batched_plan_cost(jplan, jw.catalog, batch, jp, ways=ways),
                   cost.batched_plan_cost(tplan, tw.catalog, batch, tp, ways=ways),
                   f"{label} batched {batch}/{ways}")
    _close(jcost.phys_peak_memory(jtree, jw.catalog, jp),
           cost.phys_peak_memory(ttree, tw.catalog, tp), "phys_peak_memory")
    # one set of formulas: the tree-order physical plan costs as its logical tree
    _close(cost.plan_cost(tw.plan, tw.catalog, tp),
           cost.plan_cost(ttree, tw.catalog, tp), "logical vs tree")


def test_priors_and_signatures_match_jax():
    for prior in PRIORS:
        jp, tp = getattr(jcost, prior), getattr(cost, prior)
        assert tp.signature() == jp.signature()
        assert tp.supports_kernel == jp.supports_pallas
    h100 = cost.H100_PROFILE
    assert h100.name == "gpu-h100" and h100.supports_kernel
    assert (h100.peak_flops, h100.hbm_bw) == (989e12, 3.35e12)
    a = cost.DeviceProfile.detect("cpu")
    b = dataclasses.replace(a, op_overhead_s=a.op_overhead_s * 2)
    assert a.signature() != b.signature()
    assert a.signature() == dataclasses.replace(a).signature()


def test_detect_maps_torch_devices(monkeypatch):
    p = cost.DeviceProfile.detect("cpu")
    assert p == cost.CPU_PROFILE and p is not cost.CPU_PROFILE
    p.op_overhead_s = 123.0  # a fresh copy: calibrating it leaves the prior
    assert cost.CPU_PROFILE.op_overhead_s != 123.0
    assert cost.DeviceProfile.detect("cpu").op_overhead_s != 123.0
    for capability, name, kernel in (((9, 0), "gpu-h100", True),
                                     ((8, 0), "gpu-a100", False),
                                     ((9, 1), "gpu-a100", False)):
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda dev=None, c=capability: c)
        p = cost.DeviceProfile.detect("cuda")
        assert p.name == name and p.supports_kernel == kernel
        assert p is not cost.H100_PROFILE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cost.DeviceProfile.detect()
    with pytest.raises(RuntimeError, match="CUDA"):
        cost.default_profile()
    assert cost.default_profile("cpu") is cost.default_profile(torch.device("cpu"))
    assert cost.catalog_profile(_pair("simple_q1")[1].catalog).name == "cpu"


# ---------------------------------------------------------------------------
# properties of tests/test_cost_model.py, on the port
# ---------------------------------------------------------------------------

def test_compact_after_selective_filter_cheaper_than_before():
    """Compaction after a selective filter costs less than before it, on
    every workload with such a filter over a full input (at the JAX
    package's scale for this property, 0.5; pricing only)."""
    profile = cost.DeviceProfile.detect("cpu")
    checked = 0
    for name in NAMES:
        w = twl.ALL_WORKLOADS[name](scale=0.5, device="cpu")
        for f in ir.walk(w.plan.root):
            if not isinstance(f, ir.Filter):
                continue
            after = stage_graph.sound_rows_bound(f, w.plan.registry, w.catalog)
            before = stage_graph.sound_rows_bound(f.child, w.plan.registry, w.catalog)
            cap_in = ir.infer(f, w.plan.registry, w.catalog).capacity
            if (after is None or before is None or before < cap_in * 0.95
                    or stage_graph.compact_capacity(after) >= cap_in):
                continue
            after_root = ir.replace_node(
                w.plan.root, f, ir.Compact(f, capacity=stage_graph.compact_capacity(after)))
            before_root = ir.replace_node(
                w.plan.root, f, dataclasses.replace(f, child=ir.Compact(f.child, capacity=cap_in)))
            c_after, c_before = (cost.plan_cost(ir.Plan(r, w.plan.registry, w.plan.phys),
                                                w.catalog, profile)
                                 for r in (after_root, before_root))
            assert c_after < c_before, name
            checked += 1
    assert checked >= 3


def test_kernel_costs_less_than_torch_exactly_when_bandwidth_bound():
    """Under a kernel-capable prior, the kernel realization of an R3
    node costs less than torch exactly when its bytes term binds."""
    checked = 0
    for profile in (cost.TPU_PROFILE, cost.H100_PROFILE):
        for name in NAMES:
            w = _pair(name)[1]
            plan = None
            for rule in ("R3-1", "R3-2"):
                cfgs = ALL_RULES[rule].configs(w.plan, w.catalog)
                if cfgs:
                    plan = ALL_RULES[rule].apply(w.plan, w.catalog, cfgs[0])
                    break
            if plan is None:
                continue
            uid, cfg = next(iter(plan.phys.items()))
            p_torch = plan.with_phys(uid, dataclasses.replace(cfg, backend="torch"))
            p_kernel = plan.with_phys(uid, dataclasses.replace(cfg, backend="kernel"))
            c_torch = cost.plan_cost(p_torch, w.catalog, profile)
            c_kernel = cost.plan_cost(p_kernel, w.catalog, profile)
            node = next(n for n in ir.walk(plan.root) if getattr(n, "uid", None) == uid)
            oc = cost._node_op_cost(node, plan.registry, w.catalog, profile, p_torch.phys)
            if (oc.data_bytes + oc.param_bytes) / profile.hbm_bw > oc.flops / profile.peak_flops:
                assert c_kernel < c_torch, name
            else:
                assert c_kernel == pytest.approx(c_torch, rel=1e-12), name
            checked += 1
    assert checked >= 6


def test_batched_cost_scales_with_occupancy_and_shards():
    w = _pair("rec_q2")[1]
    prof = cost.CPU_PROFILE
    c1 = cost.batched_plan_cost(w.plan, w.catalog, 1, prof)
    c8 = cost.batched_plan_cost(w.plan, w.catalog, 8, prof)
    assert c8 > c1
    assert cost.batched_plan_cost(w.plan, w.catalog, 8, prof, ways=4) < c8
    slow = dataclasses.replace(prof, collective_overhead_s=10.0)
    assert (cost.batched_plan_cost(w.plan, w.catalog, 8, slow, ways=4)
            > cost.batched_plan_cost(w.plan, w.catalog, 8, slow))


def _samples(costmod, names=("rec_q2", "simple_q1", "retail_q1"), true=None):
    out = []
    prior = costmod.CPU_PROFILE
    for name in names:
        w = _pair(name)[0 if costmod is jcost else 1]
        b = costmod.plan_cost_breakdown(w.plan, w.catalog, prior)
        ref = true or prior
        t = (b.flops / ref.peak_flops + (b.hbm_bytes + b.param_bytes) / ref.hbm_bw
             + b.n_ops * ref.op_overhead_s)
        out.append((b, t, 1.0))
    return out


def test_fit_profile_matches_jax():
    for true in (None, {"op_overhead_s": 5e-4, "hbm_bw": 6e11, "peak_flops": 2e13}):
        fits = []
        for costmod in (jcost, cost):
            t = dataclasses.replace(costmod.CPU_PROFILE, **true) if true else None
            fits.append(costmod.fit_profile(_samples(costmod, true=t), costmod.CPU_PROFILE))
        jfit, tfit = fits
        assert tfit.profile.signature() == jfit.profile.signature()
        _close(jfit.mape_after, tfit.mape_after, "mape_after")


def test_fit_profile_recovers_prior_on_consistent_data():
    prior = cost.CPU_PROFILE
    fit = cost.fit_profile(_samples(cost), prior)
    assert fit.mape_after < 1e-6
    assert fit.profile.peak_flops == pytest.approx(prior.peak_flops, rel=0.05)
    assert fit.profile.op_overhead_s == pytest.approx(prior.op_overhead_s, rel=0.05)


def test_fit_profile_moves_toward_true_device():
    prior = cost.CPU_PROFILE
    true = dataclasses.replace(prior, op_overhead_s=5e-4, hbm_bw=6e11, peak_flops=2e13)
    fit = cost.fit_profile(_samples(cost, true=true), prior)
    assert fit.mape_after < fit.mape_before
    assert fit.profile.op_overhead_s > prior.op_overhead_s * 10
    assert fit.profile.hbm_bw > prior.hbm_bw
    assert fit.profile.peak_flops > prior.peak_flops
    assert fit.profile.name.endswith("+cal")


def test_fit_profile_is_bounded_against_pathological_data():
    prior = cost.CPU_PROFILE
    b = cost.CostBreakdown(flops=1.0, hbm_bytes=1.0, param_bytes=0.0,
                           vmem_bytes=0.0, n_ops=1, seconds=1.0)
    p = cost.fit_profile([(b, 1e6, 1.0)], prior).profile
    assert prior.op_overhead_s / 100 <= p.op_overhead_s <= prior.op_overhead_s * 100
    assert prior.hbm_bw / 100 <= p.hbm_bw <= prior.hbm_bw * 100
    assert cost.fit_profile([], prior).n_samples == 0


def test_breakdown_scaled_rides_the_batch_axis():
    w = _pair("simple_q1")[1]
    b = cost.plan_cost_breakdown(w.plan, w.catalog, cost.CPU_PROFILE)
    s = b.scaled(8.0)
    assert s.flops == pytest.approx(8 * b.flops)
    assert s.hbm_bytes == pytest.approx(8 * b.hbm_bytes)
    assert s.param_bytes == b.param_bytes
    assert s.n_ops == b.n_ops
