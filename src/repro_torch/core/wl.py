"""Weisfeiler-Lehman subtree kernel (paper Alg. 6-9) — used to mine
positive/negative pairs for contrastive training of Model2Vec / Query2Vec.

Node labels are initialized per the paper: Model2Vec labels group atoms by
(kind, FLOPs bucket); Query2Vec labels encode relational-operator identity
(op type + table / predicate / join / aggregation specifics), with ML
expressions labeled through their WL features.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import ir
from repro_torch.mlfuncs.functions import MLGraph


# ---------------------------------------------------------------------------
# generic WL over an adjacency structure
# ---------------------------------------------------------------------------

def wl_features(labels: List[str], children: List[List[int]],
                iters: int = 3) -> Counter:
    """Iteratively hash (label, sorted child labels); count all labels seen
    (Alg. 6)."""
    feats: Counter = Counter(labels)
    cur = list(labels)
    for _ in range(iters):
        nxt = []
        for i, lab in enumerate(cur):
            ch = sorted(cur[c] for c in children[i])
            nxt.append(f"{lab}({','.join(ch)})")
        feats.update(nxt)
        cur = nxt
    return feats


def wl_similarity(fa: Counter, fb: Counter) -> float:
    """Cosine similarity of normalized label-frequency vectors."""
    keys = set(fa) | set(fb)
    if not keys:
        return 1.0
    va = np.array([fa.get(k, 0) for k in keys], dtype=np.float64)
    vb = np.array([fb.get(k, 0) for k in keys], dtype=np.float64)
    na, nb = np.linalg.norm(va), np.linalg.norm(vb)
    if na == 0 or nb == 0:
        return 0.0
    return float(va @ vb / (na * nb))


# ---------------------------------------------------------------------------
# Model2Vec initial labels (Alg. 7): kind + FLOPs bucket
# ---------------------------------------------------------------------------

def graph_wl(g: MLGraph, in_dims: List[int] | None = None,
             flops_bucket: float = 4.0, iters: int = 3) -> Counter:
    in_dims = in_dims or [64] * g.n_inputs
    dims = g.infer_dims(in_dims)
    labels, children = [], []
    idx = {n.id: i for i, n in enumerate(g.nodes)}
    for n in g.nodes:
        arg_dims = [in_dims[r[1]] if r[0] == "in" else dims[r[1]] for r in n.args]
        fl = max(n.atom.flops_per_row(arg_dims), 1.0)
        bucket = int(math.log(fl, flops_bucket))
        labels.append(f"{n.atom.kind}:{bucket}")
        children.append([idx[r[1]] for r in n.args if r[0] == "node"])
    return wl_features(labels, children, iters)


# ---------------------------------------------------------------------------
# Query2Vec initial labels (Alg. 9): per relational node type
# ---------------------------------------------------------------------------

def _pred_label(e: ir.Expr) -> str:
    if isinstance(e, ir.Cmp):
        col = e.a.name if isinstance(e.a, ir.Col) else "?"
        val = f"{e.b.value:.2g}" if isinstance(e.b, ir.Const) else "?"
        return f"{col}{e.op}{val}"
    if isinstance(e, ir.BoolOp):
        return f"{e.op}[{'|'.join(_pred_label(a) for a in e.args)}]"
    if isinstance(e, ir.IsIn):
        return f"in:{e.a.name if isinstance(e.a, ir.Col) else '?'}:{len(e.values)}"
    if isinstance(e, ir.Call):
        return f"ml:{_canon_fn(e.fn)}"
    return type(e).__name__


def _canon_fn(name: str) -> str:
    """Strip rule-generated suffixes so rewritten plans of the same model
    share labels."""
    for tag in ("_fact", "_dfact", "_fused", "_unfused", "_be", "_sub",
                "_res", "_mm", "_pre", "_post", "_rel"):
        i = name.find(tag)
        if i > 0:
            return name[:i]
    return name


def plan_wl(node: ir.RelNode, registry, iters: int = 3, phys=None) -> Counter:
    """WL features of a plan; ``phys`` (``Plan.phys``) labels physical
    realization choices of BlockedMatmul/ForestRelational nodes."""
    phys = phys or {}
    labels: List[str] = []
    children: List[List[int]] = []

    def visit(n: ir.RelNode) -> int:
        kid_idx = [visit(c) for c in n.children()]
        if isinstance(n, ir.Scan):
            lab = f"scan:{n.table}"
        elif isinstance(n, ir.Filter):
            lab = f"filter:{_pred_label(n.pred)}"
        elif isinstance(n, ir.Compact):
            lab = "compact"
        elif isinstance(n, ir.Project):
            mls = ",".join(sorted(_pred_label(e) for _, e in n.outputs))
            lab = f"project:{mls}"
        elif isinstance(n, ir.Join):
            lab = f"join:{n.left_key}={n.right_key}"
        elif isinstance(n, ir.CrossJoin):
            lab = "crossjoin"
        elif isinstance(n, ir.Aggregate):
            lab = f"agg:{n.key}:{','.join(k for _, (k, _) in n.aggs)}"
        elif isinstance(n, ir.BlockedMatmul):
            mode = phys.get(n.uid, ir.DEFAULT_PHYS).mode
            lab = f"blockedmm:{_canon_fn(n.fn)}:{mode}"
        elif isinstance(n, ir.ForestRelational):
            mode = phys.get(n.uid, ir.DEFAULT_PHYS).mode
            lab = f"forestrel:{_canon_fn(n.fn)}:{mode}"
        else:
            lab = type(n).__name__
        labels.append(lab)
        children.append(kid_idx)
        return len(labels) - 1

    visit(node)
    return wl_features(labels, children, iters)
