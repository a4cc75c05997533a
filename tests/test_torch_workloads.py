"""PyTorch port's engine path against the JAX package, end to end.

All 12 workloads at scale 0.3: the port's ``execute`` and
``execute_reference`` (on the CPU) against the JAX ``execute_reference``,
``.canonical()`` at rtol=atol=5e-4 with int columns and row sets exact. The
port's O3/O4 rules enumerate the JAX rules' configs (backend names mapped),
and the first config of each rule gives equal results in both packages,
R4-2's kernel backend included (its wrappers run their plain versions on
CPU tensors). ``convert`` carries JAX-built, JAX-rewritten plans across.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import executor as jex
from repro.core.rules import ALL_RULES as J_RULES
from repro.data import workloads as jwl
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import evaluator, ir
from repro_torch.core import executor as tex
from repro_torch.core.lowering import lower
from repro_torch.core.mesh import data_mesh, make_host_mesh
from repro_torch.core.optimizer import init_embedder
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.rules import ALL_RULES as T_RULES, kernel_plan
from repro_torch.data import workloads as twl
from repro_torch.kernels import common
from repro_torch.launch import serve, train as launch_train
from repro_torch.models import lm
from repro_torch.relational.table import Table
from repro_torch.serving import QueryServer
from repro_torch.testing import assert_canonical_close
from repro_torch.train import loop as train_loop

SCALE = 0.3
NAMES = sorted(jwl.ALL_WORKLOADS)
PORT_RULES = ("R3-1", "R3-2", "R3-3", "R4-1-split", "R4-1-fuse", "R4-1-unfuse",
              "R4-2", "R4-4")
SRC = Path(__file__).resolve().parents[1] / "src"


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX workload and its reference output (built once per process)."""
    w = jwl.ALL_WORKLOADS[name](scale=SCALE)
    return w, jex.execute_reference(w.plan, w.catalog).canonical()


def _port(name):
    return twl.ALL_WORKLOADS[name](scale=SCALE, device="cpu")


def _cfg_key(cfg):
    params = tuple((k, convert.backend(v) if k == "backend" else v)
                   for k, v in cfg.params)
    return cfg.rule, params


@pytest.mark.parametrize("name", NAMES)
def test_workload_matches_jax(name):
    _, ref = _jax(name)
    w = _port(name)
    assert set(w.catalog.tables) == set(_jax(name)[0].catalog.tables)
    out = tex.execute(w.plan, w.catalog, device="cpu").canonical()
    assert out and len(next(iter(out.values()))) > 0
    assert_canonical_close(ref, out, f"{name}/execute")
    assert_canonical_close(ref, tex.execute_reference(w.plan, w.catalog,
                                                      device="cpu").canonical(),
                           f"{name}/execute_reference")


@pytest.mark.parametrize("name", NAMES)
def test_rules_match_jax(name):
    """Same configs per rule; each rule's first config gives equal results
    in both packages."""
    jw, _ = _jax(name)
    w = _port(name)
    for rule in PORT_RULES:
        jcfgs = J_RULES[rule].configs(jw.plan, jw.catalog)
        tcfgs = T_RULES[rule].configs(w.plan, w.catalog)
        assert [_cfg_key(c) for c in tcfgs] == [_cfg_key(c) for c in jcfgs], rule
        if not tcfgs:
            continue
        jplan = J_RULES[rule].apply(jw.plan, jw.catalog, jcfgs[0])
        tplan = T_RULES[rule].apply(w.plan, w.catalog, tcfgs[0])
        want = jex.execute_reference(jplan, jw.catalog).canonical()
        got = tex.execute(tplan, w.catalog, device="cpu").canonical()
        assert_canonical_close(want, got, f"{name}/{rule}")


@pytest.mark.parametrize("name", NAMES)
def test_kernel_plan_matches_jax(name):
    """The whole kernel path (R3-1/R3-2, R4-2, R4-1-fuse, R4-2 on atoms)
    equals the JAX reference of the unrewritten plan."""
    _, ref = _jax(name)
    w = _port(name)
    kplan = kernel_plan(w.plan, w.catalog)
    backends = {c.backend for c in kplan.phys.values()}
    assert backends <= {"kernel"} and all(c.mode == "fused" for c in kplan.phys.values())
    assert_canonical_close(ref, tex.execute(kplan, w.catalog, device="cpu").canonical(),
                           f"{name}/kernel_plan")


def test_kernel_plan_reaches_every_kernel():
    """Across the workloads the kernel path puts all three kernels on the
    path: BlockedMatmul and ForestRelational nodes and fused_dense atoms."""
    kinds = set()
    for name in NAMES:
        w = _port(name)
        kplan = kernel_plan(w.plan, w.catalog)
        for node in ir.walk(kplan.root):
            if isinstance(node, (ir.BlockedMatmul, ir.ForestRelational)):
                kinds.add((type(node).__name__, kplan.phys_for(node).backend))
        for fn_name in kplan.registry:
            fn = kplan.registry.get(fn_name)
            for n in (fn.graph.nodes if fn.graph else ()):
                if n.atom.backend == "kernel":
                    kinds.add((n.atom.kind, "kernel"))
    assert {("BlockedMatmul", "kernel"), ("ForestRelational", "kernel"),
            ("fused_dense", "kernel")} <= kinds


# ---------------------------------------------------------------------------
# convert: JAX state carried across as plain numpy structures
# ---------------------------------------------------------------------------

def _plain(obj):
    """A JAX IR tree as nested {"node", "fields"} dicts (uids included)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"node": type(obj).__name__,
                "fields": {f.name: _plain(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, (tuple, list)):
        return tuple(_plain(o) for o in obj)
    return obj


def _plain_fn(fn):
    return {"name": fn.name, "n_inputs": fn.n_inputs, "out": fn.graph.out,
            "selectivity_hint": fn.selectivity_hint,
            "nodes": [{"id": n.id, "kind": n.atom.kind, "backend": n.atom.backend,
                       "args": n.args,
                       "params": {k: np.asarray(v) if hasattr(v, "shape") else v
                                  for k, v in n.atom.params.items()}}
                      for n in fn.graph.nodes]}


def _carry(jplan, jcat):
    tables = {k: ({c: np.asarray(v) for c, v in t.columns.items()}, np.asarray(t.valid))
              for k, t in jcat.tables.items()}
    phys = {uid: dataclasses.asdict(c) for uid, c in jplan.phys.items()}
    fns = [_plain_fn(jplan.registry.get(n)) for n in jplan.registry]
    return (convert.plan(_plain(jplan.root), fns, phys),
            convert.catalog(tables, device="cpu"))


def _jax_rewrite(w, steps):
    plan = w.plan
    for rule, wanted in steps:
        while True:
            cfg = next((c for c in J_RULES[rule].configs(plan, w.catalog) if wanted(c)), None)
            if cfg is None:
                break
            plan = J_RULES[rule].apply(plan, w.catalog, cfg)
    return plan


@pytest.mark.parametrize("name", ["rec_q3", "retail_q2", "simple_q3"])
def test_convert_carries_jax_rewritten_plan(name):
    jw, ref = _jax(name)
    original = set(jw.plan.registry)
    jplan = _jax_rewrite(jw, [
        ("R3-1", lambda c: c.get("fn") in original),
        ("R3-2", lambda c: True),
        ("R4-2", lambda c: c.get("kind") == "mode"),
        ("R4-1-fuse", lambda c: True),
        ("R4-2", lambda c: c.get("kind") == "atom" and c.get("backend") == "pallas"),
    ])
    tplan, tcat = _carry(jplan, jw.catalog)
    assert tplan.signature() == jplan.signature().replace("/jnp/", "/torch/")
    assert any(n.atom.backend == "kernel"
               for f in tplan.registry for n in tplan.registry.get(f).graph.nodes)
    want = jex.execute_reference(jplan, jw.catalog).canonical()
    assert_canonical_close(ref, want, f"{name}/jax rewritten")
    assert_canonical_close(want, tex.execute(tplan, tcat, device="cpu").canonical(),
                           f"{name}/converted")
    assert_canonical_close(want, tex.execute_reference(tplan, tcat, device="cpu").canonical(),
                           f"{name}/converted reference")


def test_convert_maps_backends_and_refuses_non_ir():
    assert convert.backend("jnp") == "torch" and convert.backend("pallas") == "kernel"
    with pytest.raises(ValueError):
        convert.ir_node({"node": "Catalog", "fields": {}})


# ---------------------------------------------------------------------------
# package boundary, devices, evaluator, lowering
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert {'repro_torch.core.plan_cache', 'repro_torch.serving.server',\n"
        "        'repro_torch.serving.feedback', 'repro_torch.core.embedding',\n"
        "        'repro_torch.core.optimizer', 'repro_torch.core.wl',\n"
        "        'repro_torch.train.optim', 'repro_torch.models.layers',\n"
        "        'repro_torch.launch.serve', 'repro_torch.core.mesh',\n"
        "        'repro_torch.launch.mesh', 'repro_torch.models.sharding',\n"
        "        'repro_torch.testing', 'repro_torch.data.tokens',\n"
        "        'repro_torch.train.checkpoint', 'repro_torch.train.loop',\n"
        "        'repro_torch.train.compress', 'repro_torch.train.elastic',\n"
        "        'repro_torch.train.stragglers', 'repro_torch.launch.train',\n"
        "        'repro_torch.launch.dryrun', 'repro_torch.launch.specs',\n"
        "        'repro_torch.launch.trace_cost', 'repro_torch.launch.trace_stats'\n"
        "        } <= set(sys.modules)\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 20


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        common.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Table.from_columns({"a": np.arange(3)})
    with pytest.raises(RuntimeError, match="CUDA"):
        twl.simple_q1(scale=SCALE)
    w = _port("simple_q1")
    with pytest.raises(RuntimeError, match="CUDA"):
        tex.execute(w.plan, w.catalog)
    with pytest.raises(RuntimeError, match="CUDA"):
        tex.execute_reference(w.plan, w.catalog)
    for entry in (lambda: PlanCache().get_or_compile(w.plan, w.catalog),
                  lambda: PlanCache().device,
                  lambda: tex.compile_plan(w.plan, w.catalog),
                  lambda: QueryServer(),
                  lambda: QueryServer(mesh=object()),
                  lambda: data_mesh(),
                  lambda: data_mesh(1),
                  lambda: make_host_mesh()):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    cfg = get_smoke_config("granite-3-2b")
    for entry in (lambda: lm.init_params(cfg), lambda: lm.init_cache(cfg, 1, 8),
                  lambda: serve.Server(cfg, batch=1, max_len=8),
                  lambda: convert.lm_params_from_numpy({"w": np.ones(2, np.float32)}),
                  lambda: init_embedder(),
                  lambda: train_loop.train(cfg, steps=1, batch=1, seq=4),
                  lambda: launch_train.main(["--arch", "granite-3-2b", "--smoke",
                                             "--steps", "1"]),
                  lambda: convert.embedder_from_numpy(
                      dict({p: {} for p in convert.EMBEDDER_PARTS}, one_model=False))):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert common.resolve_device("cpu") == torch.device("cpu")


def test_costed_lowering_is_the_default():
    """``lower`` lowers by cost unless asked not to, and ``execute`` runs
    that plan: on rec_q1 it inserts a Compact after the selective filter,
    which tree order does not."""
    from repro_torch.core import physical as ph
    w = _port("rec_q1")

    def compacts(pplan):
        return sum(isinstance(s, ph.CompactStage) for n in _phys_nodes(pplan.root)
                   if isinstance(n, ph.PPipeline) for s in n.stages)

    costed, tree = lower(w.plan, w.catalog), lower(w.plan, w.catalog, costed=False)
    assert compacts(costed) > compacts(tree) == 0
    # partitioned lowering (ways > 1) is costed too, and picks the JAX
    # package's plan under a budget that makes it partition
    from repro.core import cost as jcost
    from repro.core.lowering import lower as jlower
    from repro_torch.core import cost
    from test_torch_rules import port_signature
    jw = jwl.ALL_WORKLOADS["rec_q1"](scale=SCALE)
    budget = cost.phys_peak_memory(costed, w.catalog, cost.CPU_PROFILE) / 2
    part = lower(w.plan, w.catalog, ways=2, memory_budget=budget, profile=cost.CPU_PROFILE)
    want = jlower(jw.plan, jw.catalog, ways=2, memory_budget=budget,
                  profile=jcost.CPU_PROFILE)
    assert part.signature() == port_signature(want.signature())
    assert part.ways == want.ways and part.part_signature() == want.part_signature()


def _phys_nodes(node):
    yield node
    for c in node.children():
        yield from _phys_nodes(c)


def test_evaluator_numpy_path_matches_torch_path():
    """eval_expr over numpy dicts (ML calls through the port's atoms) ==
    over the Table, for filters, arithmetic, IsIn, IfExpr and calls."""
    w = _port("retail_q1")
    t = w.catalog.tables["order"]
    npt = {k: v.numpy() for k, v in t.columns.items()}
    reg = w.plan.registry
    exprs = [
        ir.Cmp("!=", ir.Col("weekday"), ir.Const(6)),
        ir.BinOp("/", ir.Col("weekday"), ir.BinOp("-", ir.Col("weekday"), ir.Const(2))),
        ir.BoolOp("or", (ir.IsIn(ir.Col("weekday"), (1, 3)),
                         ir.BoolOp("not", (ir.Cmp(">", ir.Col("o_store"), ir.Const(4)),)))),
        ir.IfExpr(ir.Cmp("<", ir.Col("weekday"), ir.Const(3)), ir.Col("o_store"), ir.Const(-1)),
        ir.Call("trip_classifier_dnn", (ir.Col("order_f"), ir.Col("order_f"))),
    ]
    # a function of two 40-d inputs stands in for order_f x store_f
    reg = reg.copy()
    from repro_torch.mlfuncs import builders
    reg.replace(builders.concat_ffnn("trip_classifier_dnn", [40, 40], [8, 1], seed=1))
    for e in exprs:
        a = evaluator.eval_expr(e, t, reg)
        b = evaluator.eval_expr(e, npt, reg, xp=np)
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=ir._expr_sig(e))
    col = evaluator.as_column(evaluator.eval_expr(ir.Const(2.5), t, reg), 4, t.device)
    assert col.shape == (4,) and col.dtype == torch.float32


def test_roll_tables_keeps_rows_together():
    w = _port("simple_q3")
    rolled = twl.roll_tables(w.catalog.tables, 5)
    for name, t in w.catalog.tables.items():
        r = rolled[name]
        assert torch.equal(r.valid, torch.roll(t.valid, 5, 0))
        for k in t.columns:
            assert torch.equal(r[k], torch.roll(t[k], 5, 0))
    assert len(twl.rolled_instances(w.catalog.tables["financial_account"], 3)) == 3
