"""The port's examples (``examples/torch_*.py``) against the JAX package, on
the CPU.

Each example's function runs here with ``device="cpu"``. The reference side
is built in this file the way the reference example builds it, in two
subprocesses (this file run as a script) that start with the module and run
beside the port's side: the pipeline's training and searches in one, the
rest in the other.

- ``quickstart`` at the example's full size: the same optimized plan
  (signature after ``sync_fresh_names()``), estimated costs and speedup
  (relative 1e-9), both plans' results at the ``.canonical()`` bar (5e-4,
  ints exact), the plan cache's hits, misses and traces.
- ``recommendation_pipeline`` from the reference's ``init_embedder(0)``
  (carried over by ``convert.embedder_from_numpy``), trained by the
  example's recipe in both packages with its steps cut (``TRAIN_STEPS``):
  the losses and every trained leaf at tests/test_torch_embedding.py's
  training bar (1e-4; a leaf's absolute term is 1e-4 of its network's
  largest weight: attention's key bias has no gradient, so AdamW moves it
  on rounding noise in either package); then the six queries at the
  example's search settings: the same collisions (run04 collides with
  run01), iterations, speedups, chosen plans, embeddings, node store, and
  both plans' results equal to the reference's ``execute`` of the query
  at 5e-4.
- ``train_lm``: the reference example's ``main`` at 50 steps writes its
  checkpoints; both packages resume from copies of the latest, and their
  first three losses agree at 1e-4 relative.

Printed lines are compared field by field with the reference example's
format; timing fields are never compared.
"""
import contextlib
import io
import os
import pickle
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(EXAMPLES))

import torch_quickstart  # noqa: E402
import torch_recommendation_pipeline as pipeline  # noqa: E402
import torch_train_lm  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import timing  # noqa: E402
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.testing import assert_canonical_close  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402

from test_torch_rules import port_signature, sync_fresh_names  # noqa: E402
from test_torch_search import one_torch_thread  # noqa: E402,F401

GRAD_TOL = 1e-4  # tests/test_torch_embedding.py's training bar
LOSS_RTOL = 1e-4  # the first resumed losses from one checkpoint
SPEEDUP_RTOL = 1e-9
RESUMED_LOSSES = 3
TRAIN_LM_STEPS = 50  # the reference example's main: checkpoints at 25 and 50
# the example's recipe is 40 / 40 / 80 steps, cut to fit the file's time
# (the reference's training is mostly compiles at any count); run04 still
# collides. The latency stage trains no weight that the search reads.
TRAIN_STEPS = {"m2v_steps": 10, "q2v_steps": 20, "latency_steps": 2}
# the pipeline's training and searches in one process; the quickstart,
# train_lm and the pipeline queries' results in the other
SIDES = ("search", "runs")
UNTRAINED = "untrained.pkl"
RUN_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# the reference side (run as a script: ``python THIS SIDE OUT_DIR``)
# ---------------------------------------------------------------------------

def jax_quickstart() -> dict:
    """examples/quickstart.py's steps, built the same way, with what the
    test compares."""
    import jax.numpy as jnp
    from repro.core import ir
    from repro.core.executor import execute
    from repro.core.plan_cache import PlanCache
    from repro.core.planner import analytic_cost_fn, optimize_vanilla_mcts, timed
    from repro.mlfuncs import builders
    from repro.mlfuncs.registry import Registry
    from repro.relational.table import Table

    rng = np.random.default_rng(0)
    users = Table.from_columns({
        "user_id": jnp.arange(200, dtype=jnp.int32),
        "age": jnp.asarray(rng.integers(18, 80, 200), jnp.float32),
        "user_f": jnp.asarray(rng.standard_normal((200, 32)), jnp.float32)})
    movies = Table.from_columns({
        "movie_id": jnp.arange(80, dtype=jnp.int32),
        "genre": jnp.asarray(rng.integers(0, 18, 80), jnp.int32),
        "movie_f": jnp.asarray(rng.standard_normal((80, 16)), jnp.float32)})
    catalog = ir.Catalog()
    catalog.add("users", users)
    catalog.add("movies", movies)
    registry = Registry()
    registry.register(builders.two_tower("two_tower", [32, 64, 16],
                                         [16, 64, 16], seed=1))
    trending = builders.ffnn("trending", [16, 32, 1], seed=2)
    trending.selectivity_hint = 0.5
    registry.register(trending)
    query = ir.Project(
        ir.Filter(
            ir.Filter(
                ir.CrossJoin(ir.Scan("users"), ir.Scan("movies")),
                pred=ir.IsIn(ir.Col("genre"), (1, 4, 7))),
            pred=ir.Cmp(">", ir.Call("trending", (ir.Col("movie_f"),)),
                        ir.Const(0.5))),
        outputs=(("score", ir.Call("two_tower",
                                   (ir.Col("user_f"), ir.Col("movie_f")))),),
        keep=("user_id", "movie_id"))
    plan = ir.Plan(query, registry)

    sync_fresh_names()
    cost_fn = analytic_cost_fn(catalog)
    optimized, stats = timed(optimize_vanilla_mcts, plan, catalog,
                             cost_fn=cost_fn, iterations=40)
    a = execute(plan, catalog).canonical()
    b = execute(optimized, catalog).canonical()
    cache = PlanCache()
    tables = dict(catalog.tables)
    cache.get_or_compile(optimized, catalog)(tables)
    cache.get_or_compile(optimized, catalog)(tables)
    s = cache.stats
    return {"signature": optimized.signature(), "speedup": stats["speedup"],
            "cost_before": cost_fn(plan), "cost_after": cost_fn(optimized),
            "unoptimized_result": a, "optimized_result": b,
            "hits": s.hits, "misses": s.misses, "traces": cache.traces}


def jax_pipeline(out_dir: Path) -> dict:
    """examples/recommendation_pipeline.py's training (``TRAIN_STEPS``) and
    six searches, built the same way, with what the test compares. The
    untrained weights go to ``untrained.pkl`` first, for the port's side."""
    import jax
    from repro.core import optimizer as om
    from repro.core.mcts import ReusableMCTS
    from repro.core.planner import analytic_cost_fn
    from repro.data import templates
    from repro.mlfuncs import builders

    emb = om.init_embedder(0)
    untrained = {p: jax.tree.map(np.asarray, getattr(emb, p)) for p in convert.EMBEDDER_PARTS}
    _save(out_dir / UNTRAINED, dict(untrained, one_model=emb.one_model))
    graphs = [g for g in (builders.sample_model(s).graph for s in range(24))
              if g is not None]
    losses = {"model2vec": om.train_model2vec(emb, graphs, steps=TRAIN_STEPS["m2v_steps"],
                                              batch=8, lr=1e-4)}
    plans, cats, costs = [], [], []
    for i in range(24):
        p, c = templates.sample_query(1 + (i % 3), seed=500 + i, scale=0.5)
        plans.append(p)
        cats.append(c)
        costs.append(analytic_cost_fn(c)(p))
    losses["query2vec"] = om.train_query2vec(emb, plans, cats,
                                             steps=TRAIN_STEPS["q2v_steps"], batch=8)
    losses["latency"] = om.train_latency(emb, plans, cats, costs,
                                         steps=TRAIN_STEPS["latency_steps"], batch=8)
    weights = {p: convert._flat(jax.tree.map(np.asarray, getattr(emb, p)))
               for p in convert.EMBEDDER_PARTS}

    sync_fresh_names()
    opt = ReusableMCTS(catalog_fn=None, embed_fn=emb.embed,
                       cost_fn_factory=lambda c: analytic_cost_fn(c),
                       iterations=25, warm_iterations=8, seed=0)
    rows = []
    for i in range(pipeline.QUERIES):
        plan, cat = templates.sample_query(1 + (i % 3), seed=900 + i, scale=0.5)
        best, stats = opt.optimize(plan, cat)
        rows.append({"stats": {k: stats[k] for k in ("collision", "iterations",
                                                     "replayed", "speedup")},
                     "signature": best.signature(), "embedding": emb.embed(plan, cat)})
    return {"train": losses, "weights": weights, "rows": rows,
            "collision_rate": opt.collision_rate, "states": len(opt.nodes),
            "storage_bytes": opt.storage_bytes()}


def jax_pipeline_results() -> list:
    """``execute`` of the six unoptimized queries of
    examples/recommendation_pipeline.py, to which the example holds each
    chosen plan's result."""
    from repro.core.executor import execute
    from repro.data import templates
    return [execute(*templates.sample_query(1 + (i % 3), seed=900 + i,
                                            scale=0.5)).canonical()
            for i in range(pipeline.QUERIES)]


def jax_train_lm(out_dir: Path) -> dict:
    """The reference example's ``main`` at ``TRAIN_LM_STEPS`` steps (its
    lines and checkpoints), then the reference's ``train`` resumed from a
    copy of its latest checkpoint for ``RESUMED_LOSSES`` steps."""
    import importlib.util

    from repro.train.checkpoint import latest_step
    from repro.train.loop import train as jtrain
    spec = importlib.util.spec_from_file_location("reference_train_lm",
                                                  EXAMPLES / "train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ckpt = out_dir / "train_lm_ckpt"
    argv, sys.argv = sys.argv, ["train_lm.py", "--steps", str(TRAIN_LM_STEPS),
                                "--ckpt-dir", str(ckpt)]
    stdout = io.StringIO()
    try:
        with contextlib.redirect_stdout(stdout):
            example.main()
    finally:
        sys.argv = argv
    last = latest_step(str(ckpt))
    resumed = out_dir / "train_lm_resumed"
    shutil.copytree(ckpt, resumed)
    cfg = _jax_train_lm_config()
    res = jtrain(cfg, steps=last + RESUMED_LOSSES, batch=8, seq=64, lr=torch_train_lm.LR,
                 ckpt_dir=str(resumed), ckpt_every=torch_train_lm.CKPT_EVERY)
    return {"lines": stdout.getvalue().splitlines(), "ckpt_dir": str(ckpt),
            "latest": last, "resumed_from": res.resumed_from, "losses": res.losses}


def _jax_train_lm_config():
    """examples/train_lm.py's config in the reference package."""
    import dataclasses

    from repro.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("granite-3-2b"),
                               n_layers=4, d_model=128, d_ff=512, vocab=512)


def _save(path: Path, obj) -> None:
    """Pickled, then renamed into place: a reader never sees part of it."""
    with open(path.with_suffix(".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(path.with_suffix(".tmp"), path)


def jax_side(side: str, out_dir: str) -> None:
    out = Path(out_dir)
    if side == "search":
        res = {"pipeline": jax_pipeline(out)}
    else:
        res = {"quickstart": jax_quickstart(), "train_lm": jax_train_lm(out),
               "pipeline_results": jax_pipeline_results()}
    _save(out / f"{side}.pkl", res)


# ---------------------------------------------------------------------------
# the two reference processes, started with the module
# ---------------------------------------------------------------------------

class _Reference:
    """The reference processes; ``get(side)`` waits for one and loads what
    it saved."""

    def __init__(self, out: Path):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
        self.out, self.t0, self.loaded = out, time.monotonic(), {}
        self.procs = {side: subprocess.Popen(
            [sys.executable, __file__, side, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for side in SIDES}

    def get(self, side: str) -> dict:
        if side not in self.loaded:
            p = self.procs[side]
            stdout, stderr = p.communicate(
                timeout=max(1.0, RUN_TIMEOUT_S - (time.monotonic() - self.t0)))
            assert p.returncode == 0, (f"reference {side} failed\nstdout:\n{stdout}\n"
                                       f"stderr:\n{stderr[-20000:]}")
            with open(self.out / f"{side}.pkl", "rb") as f:
                self.loaded[side] = pickle.load(f)
        return self.loaded[side]

    def untrained(self) -> dict:
        """The reference's untrained ``init_embedder(0)`` weights, which the
        search process saves before it trains."""
        path, proc = self.out / UNTRAINED, self.procs["search"]
        while not path.exists():
            if proc.poll() is not None:
                self.get("search")  # raises with the process's output
            assert time.monotonic() - self.t0 < RUN_TIMEOUT_S, "no untrained weights"
            time.sleep(0.05)
        with open(path, "rb") as f:
            return pickle.load(f)

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("examples"))
    try:
        yield ref
    finally:
        ref.close()


def _numbers_masked(line: str) -> str:
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line.replace(" ", ""))


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_pipeline(reference):
    """The port's pipeline from the reference's untrained weights. The
    tests run it first, while the reference processes work, and compare
    with them last."""
    emb = convert.embedder_from_numpy(reference.untrained(), device="cpu")
    sync_fresh_names()
    return pipeline.run(device="cpu", embedder=emb, **TRAIN_STEPS)


def test_recommendation_pipeline_runs(port_pipeline):
    """The example's table: six rows, and run04 reuses run01's search
    state (what the example shows)."""
    got = port_pipeline
    assert [r["name"] for r in got["rows"]] == [
        f"rec_template_{1 + (i % 3)} run{i:02d}" for i in range(6)]
    assert [r["stats"]["collision"] for r in got["rows"]] == [False] * 4 + [True, False]
    assert got["rows"][4]["stats"]["iterations"] == 8
    assert got["collision_rate"] == pytest.approx(1 / 6)
    assert len(got["lines"]) == 3 + 6 + 2 and got["lines"][-1].startswith("collision rate: ")


def test_quickstart_matches_reference(reference):
    sync_fresh_names()
    got = torch_quickstart.run(device="cpu")
    want = reference.get("runs")["quickstart"]
    assert got["optimized"].signature() == port_signature(want["signature"])
    assert got["stats"]["speedup"] == pytest.approx(want["speedup"], rel=SPEEDUP_RTOL)
    assert got["cost_before"] == pytest.approx(want["cost_before"], rel=SPEEDUP_RTOL)
    assert got["cost_after"] == pytest.approx(want["cost_after"], rel=SPEEDUP_RTOL)
    for k in ("unoptimized_result", "optimized_result"):
        assert_canonical_close(want[k], got[k], f"quickstart {k}")
    assert_canonical_close(want["optimized_result"], got["served_result"], "quickstart cache")
    assert (got["hits"], got["misses"], got["traces"]) == \
        (want["hits"], want["misses"], want["traces"]) == (1, 1, 1)
    # the reference's lines, but for the search's seconds
    assert got["lines"] == [
        f"estimated cost: {want['cost_before']:.3e}s -> {want['cost_after']:.3e}s"
        f"  ({want['speedup']:.1f}x, optimized in {got['stats']['opt_seconds']:.2f}s)",
        f"results identical on {len(want['unoptimized_result']['score'])} scored pairs — "
        "co-optimization is lossless.",
        "plan cache: hits=1 misses=1 traces=1 (1 trace for 2 executions)"]


def test_train_lm_matches_reference(reference, tmp_path):
    want = reference.get("runs")["train_lm"]
    got = torch_train_lm.run(device="cpu", steps=TRAIN_LM_STEPS,
                             ckpt_dir=str(tmp_path / "example"))
    # the reference example's lines, field by field; the losses differ (each
    # package draws its own initial weights) and the times are not compared
    assert [_numbers_masked(line) for line in got["lines"]] == \
        [_numbers_masked(line) for line in want["lines"]]
    assert got["resumed"].resumed_from == TRAIN_LM_STEPS // 2
    assert want["lines"][-1].startswith(f"resumed from step {TRAIN_LM_STEPS // 2};")
    assert len(got["phase1"].losses) + len(got["resumed"].losses) == TRAIN_LM_STEPS
    assert all(np.isfinite(got["phase1"].losses + got["resumed"].losses))

    # from the reference's own checkpoint, the port's first steps are its
    ckpt = tmp_path / "from_reference"
    shutil.copytree(want["ckpt_dir"], ckpt)
    res = train(torch_train_lm.lm_config(), steps=want["latest"] + RESUMED_LOSSES,
                batch=8, seq=64, lr=torch_train_lm.LR, ckpt_dir=str(ckpt),
                ckpt_every=torch_train_lm.CKPT_EVERY, device="cpu")
    assert res.resumed_from == want["resumed_from"] == want["latest"] == TRAIN_LM_STEPS
    np.testing.assert_allclose(res.losses, want["losses"], rtol=LOSS_RTOL, atol=0)
    assert len(res.losses) == RESUMED_LOSSES


def test_recommendation_pipeline_matches_reference(port_pipeline, reference):
    got = port_pipeline
    want = reference.get("search")["pipeline"]
    plain = reference.get("runs")["pipeline_results"]

    for stage, losses in want["train"].items():
        for k in ("loss_first", "loss_last"):
            assert got["train"][stage][k] == pytest.approx(losses[k], rel=GRAD_TOL), (stage, k)
    for part in convert.EMBEDDER_PARTS:
        state = getattr(got["embedder"], part).state_dict()
        assert set(state) == set(want["weights"][part]), part
        scale = max(float(np.abs(w).max()) for w in want["weights"][part].values())
        for k, w in want["weights"][part].items():
            np.testing.assert_allclose(state[k].numpy(), w, rtol=GRAD_TOL,
                                       atol=GRAD_TOL * scale, err_msg=f"trained {part}/{k}")

    assert len(got["rows"]) == len(want["rows"]) == 6
    lines = iter(got["lines"])
    assert next(lines) == "training Model2Vec/Query2Vec (contrastive, WL-mined pairs) ..."
    assert next(lines) == ""
    assert next(lines) == "query                 opt_s   collision  est_speedup  wall_speedup"
    for i, (g, w) in enumerate(zip(got["rows"], want["rows"])):
        for k in ("collision", "iterations", "replayed"):
            assert g["stats"][k] == w["stats"][k], (i, k)
        assert g["stats"]["speedup"] == pytest.approx(w["stats"]["speedup"], rel=SPEEDUP_RTOL)
        assert g["best"].signature() == port_signature(w["signature"]), i
        np.testing.assert_allclose(got["embedder"].embed(g["plan"], g["catalog"]),
                                   w["embedding"], rtol=GRAD_TOL, atol=GRAD_TOL)
        assert_canonical_close(plain[i], g["unoptimized_result"], g["name"])
        assert_canonical_close(plain[i], g["result"], f"{g['name']} chosen plan")
        # the reference's row with the port's two timing fields
        assert next(lines) == (
            f"rec_template_{1 + (i % 3)} run{i:02d}   {g['opt_s']:6.2f}   "
            f"{str(w['stats']['collision']):>5}     {w['stats']['speedup']:6.2f}x"
            f"      {g['wall_speedup']:6.2f}x")
    assert next(lines) == ""
    assert next(lines) == (f"collision rate: {want['collision_rate']:.2f}  node store: "
                           f"{want['states']} states, {want['storage_bytes']}B")
    assert next(lines, None) is None
    assert (got["collision_rate"], got["states"], got["storage_bytes"]) == \
        (want["collision_rate"], want["states"], want["storage_bytes"])


def test_timing_helpers():
    """``core.timing`` beside ``benchmarks/common.py``: the same CSV row;
    ``time_plan`` through lowering and through a plan cache (one build,
    then hits); ``best_time`` and ``time_fn`` call the closure once outside
    the window, then ``repeats`` times."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import common
    finally:
        sys.path.remove(str(ROOT))
    assert timing.csv_line("plan", 12.345, "x=1") == common.csv_line("plan", 12.345, "x=1")
    plan, catalog = torch_quickstart.build(device="cpu")
    median, first = timing.time_plan(plan, catalog, repeats=3)
    assert median > 0 and first > 0
    cache = PlanCache(device="cpu")
    for hits in (0, 1):
        timing.time_plan(plan, catalog, repeats=2, cache=cache)
        assert (cache.stats.hits, cache.stats.misses, cache.traces) == (hits, 1, 1)
    calls = []

    def fn(x=None):
        calls.append(x)
        return torch.zeros(2)

    assert timing.best_time(fn, repeats=4) >= 0 and len(calls) == 5
    assert timing.time_fn(fn, 7, repeats=3) >= 0 and calls[5:] == [7] * 4
    out = {"t": [torch.ones(1)], "n": 3}
    assert timing.block_until_ready(out) is out
    assert timing._devices(out) == {torch.device("cpu")}


if __name__ == "__main__":
    jax_side(sys.argv[1], sys.argv[2])
