"""End-to-end recommendation workload (paper Sec. V-C1) on the PyTorch port:
the MovieLens complex queries optimized by the *reusable* MCTS with trained
Query2Vec embeddings, including the state-collision speedup on repeated
templates.

    PYTHONPATH=src python examples/torch_recommendation_pipeline.py [--device cpu]

The port of ``examples/recommendation_pipeline.py``: the same training
recipe, the same six queries (templates 1-3, seeds 900-905, scale 0.5) and
search settings, and the same table. Its collisions, speedups and node
store differ from the reference example's: the port draws the embedder's
initial weights from ``torch.Generator`` streams of its own
(``optimizer.init_embedder``), not from JAX's PRNG. Started from the
reference's weights (``embedder=``, as tests/test_torch_examples.py does),
it prints the reference's table. On the card the embedder trains and the
oracle prices under the H100 prior.

``wall_speedup`` is ``core.timing.time_plan`` of the unoptimized plan over
that of the chosen one (one timed run each, after a first run).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.core import optimizer as om
from repro_torch.core.executor import execute
from repro_torch.core.mcts import ReusableMCTS
from repro_torch.core.planner import analytic_cost_fn
from repro_torch.core.timing import time_plan
from repro_torch.data import templates
from repro_torch.kernels.common import resolve_device
from repro_torch.mlfuncs import builders
from repro_torch.testing import assert_canonical_close

QUERIES = 6
SCALE = 0.5


def train_embedder(emb: om.QueryEmbedder, *, m2v_steps: int = 40, q2v_steps: int = 40,
                   latency_steps: int = 80) -> dict:
    """The example's recipe: Model2Vec on 24 sampled model graphs, then
    Query2Vec and the latency head on 24 template queries at scale 0.5,
    priced by the analytic oracle on the embedder's device. Returns each
    stage's first and last loss."""
    graphs = [g for g in (builders.sample_model(s).graph for s in range(24))
              if g is not None]
    out = {"model2vec": om.train_model2vec(emb, graphs, steps=m2v_steps, batch=8, lr=1e-4)}
    plans, cats, costs = [], [], []
    for i in range(24):
        p, c = templates.sample_query(1 + (i % 3), seed=500 + i, scale=SCALE,
                                      device=emb.device)
        plans.append(p)
        cats.append(c)
        costs.append(analytic_cost_fn(c)(p))
    out["query2vec"] = om.train_query2vec(emb, plans, cats, steps=q2v_steps, batch=8)
    out["latency"] = om.train_latency(emb, plans, cats, costs, steps=latency_steps, batch=8)
    return out


def run(*, device=None, embedder: Optional[om.QueryEmbedder] = None,
        m2v_steps: int = 40, q2v_steps: int = 40, latency_steps: int = 80) -> dict:
    """The example on ``device`` (the card unless named), from ``embedder``
    (untrained; ``init_embedder(0)`` on ``device`` by default). Each chosen
    plan's result is held to the unoptimized plan's at 5e-4. Returns what
    it prints (``lines``), the training losses, one row a query (its
    stats, both plans, their ``.canonical()`` results and ``time_plan``'s
    seconds) and the node store."""
    dev = resolve_device(device)
    lines = []

    def say(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    say("training Model2Vec/Query2Vec (contrastive, WL-mined pairs) ...")
    emb = embedder if embedder is not None else om.init_embedder(0, device=dev)
    losses = train_embedder(emb, m2v_steps=m2v_steps, q2v_steps=q2v_steps,
                            latency_steps=latency_steps)

    opt = ReusableMCTS(catalog_fn=None, embed_fn=emb.embed,
                       cost_fn_factory=lambda c: analytic_cost_fn(c),
                       iterations=25, warm_iterations=8, seed=0)

    say("")
    say("query                 opt_s   collision  est_speedup  wall_speedup")
    rows = []
    for i in range(QUERIES):
        name = f"rec_template_{1 + (i % 3)} run{i:02d}"
        plan, cat = templates.sample_query(1 + (i % 3), seed=900 + i, scale=SCALE,
                                           device=dev)
        t0 = time.perf_counter()
        best, stats = opt.optimize(plan, cat)
        opt_s = time.perf_counter() - t0
        base_t, base_first = time_plan(plan, cat, repeats=1)
        opt_t, opt_first = time_plan(best, cat, repeats=1)
        a = execute(plan, cat, device=dev).canonical()
        b = execute(best, cat, device=dev).canonical()
        assert_canonical_close(a, b, f"{name}: chosen plan against unoptimized")
        wall = base_t / max(opt_t, 1e-9)
        say(f"{name}   {opt_s:6.2f}   "
            f"{str(stats['collision']):>5}     {stats['speedup']:6.2f}x"
            f"      {wall:6.2f}x")
        rows.append({"name": name, "opt_s": opt_s, "stats": stats, "wall_speedup": wall,
                     "base_s": base_t, "opt_wall_s": opt_t, "base_first_s": base_first,
                     "opt_first_s": opt_first, "plan": plan, "best": best, "catalog": cat,
                     "unoptimized_result": a, "result": b})
    say("")
    say(f"collision rate: {opt.collision_rate:.2f}  "
        f"node store: {len(opt.nodes)} states, {opt.storage_bytes()}B")
    return {"lines": lines, "train": losses, "rows": rows, "embedder": emb,
            "collision_rate": opt.collision_rate, "states": len(opt.nodes),
            "storage_bytes": opt.storage_bytes()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="defaults to the CUDA card; 'cpu' runs the plain versions")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
