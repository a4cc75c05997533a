"""Paper Appendix K: an LM behind a black-box ``llm_summarize`` ML function
inside a SQL query, as ``examples/serve_llm_udf.py`` builds it.

    PYTHONPATH=src python -m repro_torch.launch.serve_llm_udf [--device cpu]

This runs the query's unoptimized plan through the port's ``execute``; the
optimized plan needs the MCTS planner, which is not ported yet (ROADMAP
queue 1 item 8).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import ir
from repro_torch.core.executor import execute
from repro_torch.kernels.common import resolve_device
from repro_torch.mlfuncs import builders
from repro_torch.mlfuncs.functions import MLFunction
from repro_torch.mlfuncs.registry import Registry
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.relational.table import Table


def llm_udf_query(params, cfg: ModelConfig, device=None, seed: int = 0):
    """(plan, catalog, calls): Appendix K's Q1, which LLM-summarizes both
    sides of a cross join and scores the pairs. ``calls["n"]`` counts the
    rows ``llm_summarize`` has seen. Tables are drawn from ``seed`` in the
    example's order, so both packages get the same data."""
    dev = resolve_device(device)
    calls = {"n": 0}

    def llm_summarize(feats):
        """Black-box UDF: encode a feature row into an LM 'summary' score."""
        calls["n"] += feats.shape[0]
        toks = (torch.abs(feats[:, :16]) * 37).to(torch.int32) % cfg.vocab
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
    registry.register(MLFunction("llm_summarize", graph=None,
                                 opaque_fn=llm_summarize, n_inputs=1))
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="defaults to the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    # a zoo model standing in for the paper's gpt-3.5 endpoint
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), vocab=256)
    params = lm.init_params(cfg, 0, device=args.device)
    plan, catalog, calls = llm_udf_query(params, cfg, device=args.device)
    out = execute(plan, catalog, device=args.device).canonical()
    print(f"{len(out['score'])} rows; LLM rows summarized (unoptimized plan): "
          f"{calls['n']}")


if __name__ == "__main__":
    main()
