"""The port's partitioned physical operators (the PartSpec layer) against the
JAX package's, on the CPU.

In process, without a process group: the device-free half of
``tests/test_partitioned.py`` runs in both packages on the same seeded
workloads (scale 0.25, ways 8): the partition arithmetic, PartSpec
signatures, partition sites, boundaries and side tables after ``realize``,
per-device costs and peak memory, the collectives' prices, the calibration
of the collective overhead and budgeted lowering. Decision vectors, plan
signatures and chosen candidates must be equal after the backend map
(``jnp``->``torch``, ``pallas``->``kernel``), costs at rtol 1e-9.

In a subprocess, on 8 gloo ranks (``repro_torch.testing partitioned``): the
counterpart of ``tests/partitioned_equality_driver.py`` and of the
multi-device checks of ``tests/test_partitioned.py``. All 12 workloads,
row- and hash-partitioned, equal the port's single-device run (masks and
ints exact, floats 2e-5) and rank 0's results equal the JAX package's
``execute_reference`` at the ``.canonical()`` bar.
"""
import dataclasses
import functools
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as jcost, costed_lowering as jcl, executor as jex
from repro.core import mesh as jmesh
from repro.core import physical as jph
from repro.core import stage_graph as jsg
from repro.core.rules import ALL_RULES as J_RULES
from repro.data import workloads as jwl
from repro_torch.core import cost, costed_lowering, stage_graph
from repro_torch.core import mesh as mesh_util
from repro_torch.core import physical as ph
from repro_torch.core.lowering import lower
from repro_torch.data import workloads as twl
from repro_torch.testing import (GROUP_TIMEOUT_S, MESH_SCALE, WORKLOAD_TOL,
                                 assert_canonical_close, load_canonical, partition_budget)

from test_torch_rules import port_signature as _signature, sync_fresh_names

WAYS = 8
NAMES = sorted(jwl.ALL_WORKLOADS)
SRC = Path(__file__).resolve().parent.parent / "src"
RANKS_TIMEOUT_S = 2 * GROUP_TIMEOUT_S + 60  # the subprocess's, above the group's


@functools.lru_cache(maxsize=None)
def _pair(name):
    return (jwl.ALL_WORKLOADS[name](scale=MESH_SCALE),
            twl.ALL_WORKLOADS[name](scale=MESH_SCALE, device="cpu"))


def _graphs(name, prior="CPU_PROFILE"):
    jw, tw = _pair(name)
    return (jsg.build(jw.plan, jw.catalog, profile=getattr(jcost, prior), ways=WAYS),
            stage_graph.build(tw.plan, tw.catalog, profile=getattr(cost, prior), ways=WAYS))


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _parts(pplan) -> dict:
    return {p: s.signature() for p, s in pplan.parts.items()}


# ---------------------------------------------------------------------------
# partition arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,ways", [(16, 8), (17, 8), (5, 8), (1, 1), (1000, 3),
                                           (289_000, 4), (37, 8)])
def test_row_block_and_padding_match_jax(capacity, ways):
    assert mesh_util.row_block(capacity, ways) == jmesh.row_block(capacity, ways)
    assert mesh_util.padded_capacity(capacity, ways) == jmesh.padded_capacity(capacity, ways)
    assert mesh_util.padded_capacity(capacity, ways) >= capacity


def test_row_block_refuses_zero_ways():
    with pytest.raises(ValueError):
        mesh_util.row_block(8, 0)
    assert mesh_util.row_block(17, 8) == 3 and mesh_util.padded_capacity(17, 8) == 24


@pytest.mark.parametrize("ways", [1, 2, 3, 8])
def test_hash_bucket_matches_jax_including_negative_keys(ways):
    keys = np.random.default_rng(ways).integers(-2 ** 31, 2 ** 31 - 1, 257).astype(np.int32)
    keys[:6] = [0, 7, 8, 21, -3, -2 ** 31]
    got = mesh_util.hash_bucket(torch.from_numpy(keys), ways)
    want = np.asarray(jmesh.hash_bucket(jnp.asarray(keys), ways))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < ways
    assert list(mesh_util.hash_bucket([0, 7, 8, 21, -3], 8)) == [0, 7, 0, 5, 5]


def test_partspec_signatures_match_jax():
    for kind, ways, key in (("rep", 1, None), ("row", 8, None), ("hash", 8, "k"),
                            ("row", 3, None), ("hash", 2, "movie_id")):
        assert (ph.PartSpec(kind, ways, key).signature()
                == jph.PartSpec(kind, ways, key).signature())
    assert ph.REPLICATED.signature() == "rep"
    assert ph.PartSpec(kind="hash", ways=8, key="k").signature() == "hash8[k]"


def test_launch_mesh_reexports_core():
    from repro_torch.launch import mesh as launch_mesh
    assert launch_mesh.make_host_mesh is mesh_util.make_host_mesh


# ---------------------------------------------------------------------------
# stage-graph partition sites + realization, on all 12 workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_partition_sites_and_realizations_match_jax(name):
    """Sites (kinds and options), the row- and hash-partitioned
    realizations (signatures, side tables, ways) and their per-device
    costs and peak memory equal the JAX package's; without ``ways`` no
    partition site exists, and the default keeps tree order."""
    jw, tw = _pair(name)
    one = stage_graph.build(tw.plan, tw.catalog, profile=cost.CPU_PROFILE)
    assert not any(s.kind == "part" for s in one.sites.values())
    jg, tg = _graphs(name)
    assert sorted(tg.sites) == sorted(jg.sites)
    parts = [s for s in tg.sites.values() if s.kind == "part"]
    assert parts, name
    for s in parts:
        js = jg.sites[s.sid]
        assert [o.signature() for o in s.options] == [o.signature() for o in js.options]
        assert s.options[0] == ph.REPLICATED and s.default == 0
        assert s.options[1] == ph.PartSpec(kind="row", ways=WAYS)
    assert tg.partitioned_decisions() == jg.partitioned_decisions()
    # the default realization is the tree-order plan: no boundary, no parts
    pp = tg.realize(tg.default_decisions())
    assert pp.signature() == lower(tw.plan, tw.catalog, costed=False).signature()
    assert not pp.parts and pp.ways == 1
    flavours = {"row": tg.partitioned_decisions()}
    hash_sites = [s.sid for s in parts if len(s.options) > 2]
    if hash_sites:
        d = tg.default_decisions()
        for s in parts:
            d[s.sid] = len(s.options) - 1
        flavours["hash"] = d
    for flavour, d in flavours.items():
        label = f"{name}/{flavour}"
        tp, jp = tg.realize(d), jg.realize(d)
        assert tp.signature() == _signature(jp.signature()), label
        assert _parts(tp) == _parts(jp) and tp.ways == jp.ways == WAYS, label
        assert tp.part_signature() == jp.part_signature() != "rep", label
        assert isinstance(tp.root, ph.PRepartition), label
        assert tp.root.op in ("allgather", "combine"), label
        for prof in ("CPU_PROFILE", "TPU_PROFILE"):
            tc = cost.plan_cost(tp, tw.catalog, getattr(cost, prof))
            jc = jcost.plan_cost(jp, jw.catalog, getattr(jcost, prof))
            assert tc == pytest.approx(jc, rel=1e-9), (label, prof)
            tm = cost.phys_peak_memory(tp, tw.catalog, getattr(cost, prof))
            jm = jcost.phys_peak_memory(jp, jw.catalog, getattr(jcost, prof))
            assert tm == pytest.approx(jm, rel=1e-9), (label, prof)


def test_partitioned_realize_inserts_boundaries_and_side_table():
    _, tw = _pair("retail_q3")
    _, g = _graphs("retail_q3")
    pp = g.realize(g.partitioned_decisions())
    assert [n for n in _walk(pp.root) if isinstance(n, ph.PRepartition)]
    assert pp.parts and all(s.kind != "rep" for s in pp.parts.values())
    for path in pp.parts:  # every recorded path names a real node
        node = pp.root
        for seg in path.split(".")[1:]:
            node = node.children()[int(seg)]
        assert pp.part_for(path) == pp.parts[path]
    assert pp.part_for("r.9.9") == ph.REPLICATED
    # a partitioned plan refuses to run without a mesh
    with pytest.raises(RuntimeError, match="mesh"):
        ph.run(pp, dict(tw.catalog.tables))


def test_row_partition_splits_pipeline_at_last_compact():
    """A row-partitioned pipeline with an inserted compact keeps the compact
    in a replicated prefix and partitions only the row-local suffix, as the
    JAX package's does."""
    jg, tg = _graphs("analytics_q1")
    d = tg.partitioned_decisions()
    compact_sites = [s for s in tg.sites.values() if s.kind == "compact"]
    assert compact_sites
    for s in compact_sites:
        d[s.sid] = 1
    tp, jp = tg.realize(d), jg.realize(d)
    assert tp.signature() == _signature(jp.signature())
    assert _parts(tp) == _parts(jp)
    for path, node in _paths(tp.root):
        if isinstance(node, ph.PPipeline) and any(isinstance(st, ph.CompactStage)
                                                  for st in node.stages):
            assert tp.part_for(path).kind == "rep", path


def _paths(node, path="r"):
    yield path, node
    for i, c in enumerate(node.children()):
        yield from _paths(c, f"{path}.{i}")


# ---------------------------------------------------------------------------
# per-device costing + peak memory
# ---------------------------------------------------------------------------

def test_partitioned_peak_memory_below_replicated():
    _, tw = _pair("retail_q3")
    _, g = _graphs("retail_q3")
    peak_rep = cost.phys_peak_memory(g.realize(g.default_decisions()), tw.catalog,
                                     cost.CPU_PROFILE)
    peak_part = cost.phys_peak_memory(g.realize(g.partitioned_decisions()), tw.catalog,
                                      cost.CPU_PROFILE)
    assert peak_part < 0.5 * peak_rep, (peak_part, peak_rep)


def test_repartition_costs_match_jax_and_price_collectives():
    """Boundary ops carry exchange volume and per-shard collective launches,
    field for field as the JAX package prices them; a partitioned plan's
    cost grows with the profile's collective overhead."""
    jw, tw = _pair("retail_q3")
    jg, tg = _graphs("retail_q3")
    for prior in ("CPU_PROFILE", "TPU_PROFILE", "H100_PROFILE"):
        assert getattr(cost, prior).collective_overhead_s > 0
    d = tg.partitioned_decisions()
    tp, jp = tg.realize(d), jg.realize(d)
    tocs = cost.phys_op_costs(tp, tw.catalog, cost.CPU_PROFILE)
    jocs = jcost.phys_op_costs(jp, jw.catalog, jcost.CPU_PROFILE)
    assert [o.label for o in tocs] == [o.label for o in jocs]
    for t, j in zip(tocs, jocs):
        for f in ("flops", "data_bytes", "param_bytes", "n_coll"):
            assert getattr(t, f) == pytest.approx(getattr(j, f), rel=1e-9), (t.label, f)
    reparts = [oc for oc in tocs if oc.label.startswith("repart")]
    assert reparts and any(oc.n_coll == WAYS for oc in reparts)
    slow = dataclasses.replace(cost.CPU_PROFILE, collective_overhead_s=1.0)
    assert cost.plan_cost(tp, tw.catalog, slow) > cost.plan_cost(tp, tw.catalog,
                                                                  cost.CPU_PROFILE)
    b = cost.plan_cost_breakdown(tp, tw.catalog, cost.CPU_PROFILE)
    jb = jcost.plan_cost_breakdown(jp, jw.catalog, jcost.CPU_PROFILE)
    assert b.n_coll == jb.n_coll >= WAYS


def test_fit_profile_calibrates_collective_overhead_as_jax():
    """Samples with a non-zero n_coll column identify collective_overhead_s;
    without them it stays at the prior. Both packages fit the same
    profile."""
    def fit(mod):
        prior = mod.CPU_PROFILE
        b = mod.CostBreakdown(flops=1e6, hbm_bytes=1e4, param_bytes=0.0,
                              vmem_bytes=0.0, n_ops=2, seconds=0.0, n_coll=8.0)
        true_co = prior.collective_overhead_s * 50

        def t(x):
            return (x.flops / prior.peak_flops + x.hbm_bytes / prior.hbm_bw
                    + x.n_ops * prior.op_overhead_s + x.n_coll * true_co)

        samples = [(s, t(s), 1.0) for s in (b, dataclasses.replace(b, n_coll=32.0),
                                            dataclasses.replace(b, n_coll=64.0))]
        b0 = dataclasses.replace(b, n_coll=0.0)
        return prior, mod.fit_profile(samples, prior), mod.fit_profile([(b0, t(b0), 1.0)], prior)

    prior, f, f0 = fit(cost)
    _, jf, jf0 = fit(jcost)
    assert f.mape_after < f.mape_before
    assert f.profile.collective_overhead_s > prior.collective_overhead_s * 5
    assert f0.profile.collective_overhead_s == pytest.approx(prior.collective_overhead_s,
                                                             rel=0.2)
    for a, b in ((f, jf), (f0, jf0)):
        for k in ("peak_flops", "hbm_bw", "op_overhead_s", "collective_overhead_s"):
            assert getattr(a.profile, k) == pytest.approx(getattr(b.profile, k), rel=1e-9)
        assert a.mape_after == pytest.approx(b.mape_after, rel=1e-9)


def test_profile_signature_tracks_budget_and_collectives():
    a = cost.DeviceProfile.detect("cpu")
    assert a.signature() != dataclasses.replace(
        a, collective_overhead_s=a.collective_overhead_s * 2).signature()
    assert a.signature() != dataclasses.replace(a, memory_budget=1e6).signature()
    assert a.signature() == jcost.DeviceProfile.detect().signature()


# ---------------------------------------------------------------------------
# memory-budget pruning in costed lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prior", ["CPU_PROFILE", "TPU_PROFILE"])
@pytest.mark.parametrize("name", NAMES)
def test_budgeted_partitioned_lowering_matches_jax(name, prior):
    """Under a per-device budget between the partitioned and the replicated
    peak, ``lower_costed(ways=8)`` chooses the JAX package's candidate:
    the same decisions (PartSpec vector included), signature, cost,
    candidates scored and pruned, and a plan that fits where one exists."""
    jw, tw = _pair(name)
    profile = getattr(cost, prior)
    rep, part, budget = partition_budget(tw.plan, tw.catalog, WAYS, profile)
    budget = budget if part < rep else None
    tl = costed_lowering.lower_costed(tw.plan, tw.catalog, profile=profile,
                                      memory_budget=budget, ways=WAYS)
    jl = jcl.lower_costed(jw.plan, jw.catalog, profile=getattr(jcost, prior),
                          memory_budget=budget, ways=WAYS)
    assert tl.decisions == jl.decisions
    assert tl.signature == _signature(jl.signature)
    assert tl.plan.signature() == _signature(jl.plan.signature())
    assert _parts(tl.plan) == _parts(jl.plan) and tl.plan.ways == jl.plan.ways
    assert (tl.candidates_scored, tl.budget_pruned, tl.budget_pruned_all) == (
        jl.candidates_scored, jl.budget_pruned, jl.budget_pruned_all)
    for k in ("cost", "baseline_cost", "peak_memory"):
        assert getattr(tl, k) == pytest.approx(getattr(jl, k), rel=1e-9), k
    if budget is not None and not tl.budget_pruned_all:
        assert tl.peak_memory <= budget


FULL_SIZE = (("analytics_q1", 100.0), ("rec_q3", 20.0))  # chip_smoke.py's


def _h100(module):
    """The port's H100 prior as a ``module.DeviceProfile``."""
    fields = dataclasses.asdict(cost.H100_PROFILE)
    if module is jcost:
        fields["supports_pallas"] = fields.pop("supports_kernel")
    return module.DeviceProfile(**fields)


@pytest.mark.parametrize("name,scale", FULL_SIZE)
def test_full_size_budgeted_lowering_matches_jax(name, scale):
    """The full-size queries ``chip_smoke.py``'s [mesh] phase serves, as
    kernel plans on 4 ranks under the H100 prior and ``partition_budget``
    (pricing only, nothing executed): the server routes each query in both
    packages, and both lower it to the same row-partitioned plan that fits
    (the same decisions, signature, candidates scored and pruned). At
    analytics_q1@100 the budget lies within 2% of the replicated peak: the
    scanned tables stay whole on every rank."""
    from repro_torch.core.rules import kernel_plan
    from test_torch_lowering import _jax_kernel_plan
    ways = 4
    sync_fresh_names()
    jw = jwl.ALL_WORKLOADS[name](scale=scale)
    tw = twl.ALL_WORKLOADS[name](scale=scale, device="cpu")
    jplan, tplan = _jax_kernel_plan(jw.plan, jw.catalog), kernel_plan(tw.plan, tw.catalog)
    tp, jp = _h100(cost), _h100(jcost)
    rep, part, budget = partition_budget(tplan, tw.catalog, ways, tp)
    assert part < budget < rep
    assert cost.plan_peak_memory(tplan, tw.catalog, tp) == pytest.approx(rep, rel=1e-9)
    assert jcost.plan_peak_memory(jplan, jw.catalog, jp) > budget  # JAX's server routes it
    tl = costed_lowering.lower_costed(tplan, tw.catalog, profile=tp, memory_budget=budget,
                                      ways=ways)
    jl = jcl.lower_costed(jplan, jw.catalog, profile=jp, memory_budget=budget, ways=ways)
    assert tl.decisions == jl.decisions
    assert tl.signature == _signature(jl.signature)
    assert (tl.candidates_scored, tl.budget_pruned, tl.budget_pruned_all) == (
        jl.candidates_scored, jl.budget_pruned, jl.budget_pruned_all)
    assert _parts(tl.plan) == _parts(jl.plan)
    assert tl.plan.ways == ways and tl.plan.parts and not tl.budget_pruned_all
    assert tl.peak_memory <= budget
    assert tl.peak_memory == pytest.approx(jl.peak_memory, rel=1e-9)


def test_budget_selects_partitioned_plan_that_fits():
    _, tw = _pair("retail_q3")
    rep, _, _ = partition_budget(tw.plan, tw.catalog, WAYS, cost.CPU_PROFILE)
    low = costed_lowering.lower_costed(tw.plan, tw.catalog, profile=cost.CPU_PROFILE,
                                       memory_budget=rep * 0.6, ways=WAYS)
    assert low.plan.ways == WAYS and low.plan.parts
    assert low.peak_memory <= rep * 0.6
    assert low.budget_pruned > 0 and not low.budget_pruned_all
    assert low.memory_budget == rep * 0.6


def test_budget_pruning_all_candidates_is_loud(caplog):
    """A budget nothing can fit falls back to tree order AND says so, in
    the decision record and the log, with the JAX package's counts."""
    jw, tw = _pair("simple_q1")
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.costed_lowering"):
        low = costed_lowering.lower_costed(tw.plan, tw.catalog, profile=cost.CPU_PROFILE,
                                           memory_budget=64.0, ways=WAYS)
    jlow = jcl.lower_costed(jw.plan, jw.catalog, profile=jcost.CPU_PROFILE,
                            memory_budget=64.0, ways=WAYS)
    assert low.budget_pruned_all and low.budget_pruned == low.candidates_scored
    assert low.candidates_scored == jlow.candidates_scored
    assert low.peak_memory > 64.0
    assert any("pruned all" in r.message and "ways=8" in r.message for r in caplog.records)
    low2 = costed_lowering.lower_costed(tw.plan, tw.catalog, profile=cost.CPU_PROFILE)
    assert not low2.budget_pruned_all and low2.budget_pruned == 0


def test_profile_budget_is_the_default_budget():
    _, tw = _pair("simple_q1")
    profile = dataclasses.replace(cost.CPU_PROFILE, memory_budget=64.0)
    low = costed_lowering.lower_costed(tw.plan, tw.catalog, profile=profile)
    assert low.memory_budget == 64.0 and low.budget_pruned_all


def test_tree_order_lowering_ignores_ways_as_jax():
    """``costed=False`` is the tree-order baseline whatever ``ways`` says,
    in both packages."""
    from repro.core.lowering import lower as jlower
    jw, tw = _pair("retail_q3")
    got = lower(tw.plan, tw.catalog, costed=False, ways=WAYS)
    want = jlower(jw.plan, jw.catalog, costed=False, ways=WAYS)
    assert got.signature() == _signature(want.signature())
    assert not got.parts and got.ways == 1


# ---------------------------------------------------------------------------
# the full multi-rank proof: 8 gloo ranks in a subprocess
# ---------------------------------------------------------------------------

def launch_suite(suite: str, out: Path) -> subprocess.CompletedProcess:
    """``repro_torch.testing <suite>`` on 8 gloo ranks, run to its end."""
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.testing", suite, "--ways", str(WAYS),
         "--out", str(out), "--timeout", str(GROUP_TIMEOUT_S)],
        env=env, capture_output=True, text=True, timeout=RANKS_TIMEOUT_S)


def run_suite(suite: str, out: Path) -> str:
    """``repro_torch.testing <suite>`` on 8 gloo ranks; its standard output."""
    proc = launch_suite(suite, out)
    assert proc.returncode == 0, (
        f"{suite} ranks failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-20000:]}")
    return proc.stdout


PARTITIONED_OK = (
    "all 12 workloads: partitioned == one device", "rec_q3/R3-1: OK",
    "analytics_q1/R3-2: OK", "skew all-one-bucket: OK", "skew empty-buckets: OK",
    "skew uniform-53: OK", "skewed join property (12 examples): OK",
    "budgeted serving: OK", "partitioned cache entry is first class: OK",
    "partitioned composes with a backend override: OK",
    "1-wide mesh falls back to the plain entry: OK",
    "server routes the oversized query to the partitioned path: OK",
    "ranks that disagree about the plan raise: OK", "partitioned suite: OK")


def test_partitioned_equals_reference_all_workloads_8ranks(tmp_path):
    """8 gloo ranks: row- and hash-partitioned realizations of all 12
    workloads equal one device (masks and ints exact, floats 2e-5), skewed
    joins stay exact, an R3 plan partitions by rows, and the memory-budget
    serving path works end to end; rank 0's results equal the JAX
    package's ``execute_reference`` at the ``.canonical()`` bar."""
    out = run_suite("partitioned", tmp_path)
    for line in PARTITIONED_OK:
        assert line in out, line
    saved = {p.stem for p in tmp_path.glob("*.npz")}
    for name in NAMES:
        jw, _ = _pair(name)
        ref = jex.execute_reference(jw.plan, jw.catalog).canonical()
        flavours = [f for f in ("row", "hash") if f"{name}.{f}" in saved]
        assert "row" in flavours, name
        for f in flavours:
            assert f"{name}/{f}: OK" in out
            assert_canonical_close(ref, load_canonical(tmp_path, f"{name}.{f}"),
                                   f"{name}/{f}", WORKLOAD_TOL)
    assert {f"{n}.hash" for n in NAMES} & saved  # the joins' hash flavour ran
    sync_fresh_names()
    for name, rule in (("rec_q3", "R3-1"), ("analytics_q1", "R3-2")):
        jw, _ = _pair(name)
        cfgs = J_RULES[rule].configs(jw.plan, jw.catalog)
        plan = J_RULES[rule].apply(jw.plan, jw.catalog, cfgs[0])
        assert_canonical_close(jex.execute_reference(plan, jw.catalog).canonical(),
                               load_canonical(tmp_path, f"{name}.{rule}"), rule, WORKLOAD_TOL)
    jw, _ = _pair("retail_q3")
    assert_canonical_close(jex.execute_reference(jw.plan, jw.catalog).canonical(),
                           load_canonical(tmp_path, "served-oversized"), "served",
                           WORKLOAD_TOL)
