"""Quickstart on the PyTorch port: build a catalog, register an ML model,
write an inference query in the three-level IR, optimize it with MCTS,
execute, verify, and serve it twice through the compiled-plan cache.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of ``examples/quickstart.py``: the same tables, models and query,
drawn from ``np.random.default_rng(0)`` and the builders' seeds, so the
optimizer prices the same plans. It runs on the CUDA card unless
``--device`` names another device, and then prices plans under that
device's profile: on the CPU it prints the reference's estimated costs; on
an H100 it prices them under the H100 prior. On the card the plan cache's
one "trace" is one captured CUDA graph.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import ir
from repro_torch.core.executor import execute
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import analytic_cost_fn, optimize_vanilla_mcts, timed
from repro_torch.kernels.common import resolve_device
from repro_torch.mlfuncs import builders
from repro_torch.mlfuncs.registry import Registry
from repro_torch.relational.table import Table
from repro_torch.testing import assert_canonical_close


def build(*, device=None, n_users: int = 200, n_movies: int = 80):
    """(plan, catalog): the example's tables on ``device``, its two-tower
    and trending models, and the inference query over them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    # 1. base tables (paper Fig. 3: preprocessed user/movie features)
    users = Table.from_columns({
        "user_id": np.arange(n_users, dtype=np.int32),
        "age": rng.integers(18, 80, n_users).astype(np.float32),
        "user_f": rng.standard_normal((n_users, 32)).astype(np.float32)}, device=dev)
    movies = Table.from_columns({
        "movie_id": np.arange(n_movies, dtype=np.int32),
        "genre": rng.integers(0, 18, n_movies).astype(np.int32),
        "movie_f": rng.standard_normal((n_movies, 16)).astype(np.float32)}, device=dev)
    catalog = ir.Catalog()
    catalog.add("users", users)
    catalog.add("movies", movies)

    # 2. load + register the two-tower model (Fig. 3 steps 1-2)
    registry = Registry()
    registry.register(builders.two_tower("two_tower", [32, 64, 16],
                                         [16, 64, 16], seed=1))
    trending = builders.ffnn("trending", [16, 32, 1], seed=2)
    trending.selectivity_hint = 0.5
    registry.register(trending)

    # 3. the inference query (Fig. 3 step 3): filter movies, cross join
    #    users, score each pair with the two-tower model
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
    return ir.Plan(query, registry), catalog


def run(*, device=None, n_users: int = 200, n_movies: int = 80) -> dict:
    """The example's steps on ``device`` (the card unless named). Returns
    what it prints: ``lines``, the estimated costs, the search's stats, both
    plans and their ``.canonical()`` results, and the cache's counts."""
    dev = resolve_device(device)
    plan, catalog = build(device=dev, n_users=n_users, n_movies=n_movies)
    lines = []

    def say(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    # 4. optimize (reusable-MCTS action space: R1/R2/R3/R4 rules), priced
    #    under the profile of the device the catalog lives on
    cost_fn = analytic_cost_fn(catalog)
    optimized, stats = timed(optimize_vanilla_mcts, plan, catalog,
                             cost_fn=cost_fn, iterations=40)
    cost_before, cost_after = cost_fn(plan), cost_fn(optimized)
    say(f"estimated cost: {cost_before:.3e}s -> {cost_after:.3e}s"
        f"  ({stats['speedup']:.1f}x, optimized in {stats['opt_seconds']:.2f}s)")

    # 5. execute both (execute lowers to the physical plan layer and runs
    #    the fused pipelines), verify equivalence
    a = execute(plan, catalog, device=dev).canonical()
    b = execute(optimized, catalog, device=dev).canonical()
    assert_canonical_close(a, b, "quickstart: optimized against unoptimized")
    say(f"results identical on {len(a['score'])} scored pairs — "
        "co-optimization is lossless.")

    # 6. serve repeated traffic through the compiled-plan cache: a second
    #    structurally identical query skips lowering AND the capture
    cache = PlanCache(device=dev)
    tables = dict(catalog.tables)
    cache.get_or_compile(optimized, catalog)(tables)   # miss: lower + capture
    served = cache.get_or_compile(optimized, catalog)(tables)  # hit: replay only
    s = cache.stats
    say(f"plan cache: hits={s.hits} misses={s.misses} "
        f"traces={cache.traces} (1 trace for 2 executions)")
    return {"lines": lines, "plan": plan, "optimized": optimized, "catalog": catalog,
            "cost_before": cost_before, "cost_after": cost_after, "stats": stats,
            "unoptimized_result": a, "optimized_result": b,
            "served_result": served.canonical(), "hits": s.hits, "misses": s.misses,
            "traces": cache.traces}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="defaults to the CUDA card; 'cpu' runs the plain versions")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
