"""Paper Appendix K: an LM behind a black-box ``llm_summarize`` ML function
inside a SQL query, as ``examples/serve_llm_udf.py`` builds it.

    PYTHONPATH=src python -m repro_torch.launch.serve_llm_udf [--device cpu]

It runs the query's unoptimized plan and the plan ``optimize_vanilla_mcts``
chooses (40 iterations, seed 0, the analytic oracle under the profile of
the catalog's device), requires equal results and prints how many rows
each plan had the LLM summarize: pushing the call below the cross join
(R4-1 + R1-3) summarizes each row once instead of once per pair.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import ir
from repro_torch.core.executor import execute
from repro_torch.core.planner import analytic_cost_fn, optimize_vanilla_mcts
from repro_torch.kernels.common import resolve_device
from repro_torch.mlfuncs import builders
from repro_torch.mlfuncs.functions import MLFunction
from repro_torch.mlfuncs.registry import Registry
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.relational.table import Table
from repro_torch.testing import assert_canonical_close


LLM_TOKENS = 16  # tokens of a feature row the LLM reads


def llm_udf_query(params, cfg: ModelConfig, device=None, seed: int = 0):
    """(plan, catalog, calls): Appendix K's Q1, which LLM-summarizes both
    sides of a cross join and scores the pairs. ``calls["n"]`` counts the
    rows ``llm_summarize`` has seen. Tables are drawn from ``seed`` in the
    example's order, so both packages get the same data. ``llm_summarize``
    declares its cost, one forward pass of ``LLM_TOKENS`` tokens a row
    (2 x parameters x tokens FLOPs); the reference's oracle prices a black
    box at 1e6 FLOPs a row, and under an accelerator's prior that makes the
    LLM look free and leaves the calls above the cross join."""
    dev = resolve_device(device)
    calls = {"n": 0}

    def llm_summarize(feats):
        """Black-box UDF: encode a feature row into an LM 'summary' score."""
        calls["n"] += feats.shape[0]
        toks = (torch.abs(feats[:, :LLM_TOKENS]) * 37).to(torch.int32) % cfg.vocab
        h = lm.forward(params, cfg, toks)
        # float32, as JAX promotes a bf16 input of the f32 towers
        return h[:, -1, :8].float()

    rng = np.random.default_rng(seed)
    users = Table.from_columns({
        "user_id": np.arange(24, dtype=np.int32),
        "user_desc": rng.standard_normal((24, 16)).astype(np.float32)}, device=dev)
    movies = Table.from_columns({
        "movie_id": np.arange(12, dtype=np.int32),
        "lang_en": rng.integers(0, 2, 12).astype(np.int32),
        "movie_desc": rng.standard_normal((12, 16)).astype(np.float32)}, device=dev)
    catalog = ir.Catalog()
    catalog.add("users", users)
    catalog.add("movies", movies)

    registry = Registry()
    registry.register(MLFunction("llm_summarize", graph=None, opaque_fn=llm_summarize,
                                 n_inputs=1,
                                 flops_hint=2.0 * cfg.param_count() * LLM_TOKENS))
    registry.register(builders.two_tower("recommend", [8, 16, 8], [8, 16, 8],
                                         seed=1))
    q = ir.Project(
        ir.Filter(ir.CrossJoin(ir.Scan("users"), ir.Scan("movies")),
                  pred=ir.Cmp("==", ir.Col("lang_en"), ir.Const(1))),
        outputs=(("score", ir.Call("recommend", (
            ir.Call("llm_summarize", (ir.Col("user_desc"),)),
            ir.Call("llm_summarize", (ir.Col("movie_desc"),))))),),
        keep=("user_id", "movie_id"))
    return ir.Plan(q, registry), catalog, calls


def naive_and_optimized(plan: ir.Plan, catalog: ir.Catalog, calls: dict,
                        device=None) -> dict:
    """Both plans of the query, each executed once: their results, the
    optimized plan (examples/serve_llm_udf.py's search: vanilla MCTS, 40
    iterations, seed 0) and the rows each had ``llm_summarize`` see."""
    calls["n"] = 0
    naive = execute(plan, catalog, device=device).canonical()
    naive_rows = calls["n"]
    opt, stats = optimize_vanilla_mcts(plan, catalog, cost_fn=analytic_cost_fn(catalog),
                                       iterations=40, seed=0)
    calls["n"] = 0
    out = execute(opt, catalog, device=device).canonical()
    return {"naive": naive, "optimized": out, "plan": opt, "stats": stats,
            "naive_rows": naive_rows, "optimized_rows": calls["n"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="defaults to the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    # a zoo model standing in for the paper's gpt-3.5 endpoint
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), vocab=256)
    params = lm.init_params(cfg, 0, device=args.device)
    plan, catalog, calls = llm_udf_query(params, cfg, device=args.device)
    r = naive_and_optimized(plan, catalog, calls, device=args.device)
    assert_canonical_close(r["naive"], r["optimized"], "llm_udf optimized")
    print(f"{len(r['naive']['score'])} rows; LLM rows summarized: naive="
          f"{r['naive_rows']}  optimized={r['optimized_rows']} "
          f"({r['naive_rows'] / max(r['optimized_rows'], 1):.1f}x fewer inferences, "
          "same results)")


if __name__ == "__main__":
    main()
