"""Pure-numpy reference semantics for the relational operators.

Tables here are plain dicts of numpy arrays containing only live rows; used
by tests and by the equivalence checker to validate the engine and every
rewrite rule.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

NpTable = Dict[str, np.ndarray]


def filter_(t: NpTable, mask: np.ndarray) -> NpTable:
    return {k: v[mask] for k, v in t.items()}


def project(t: NpTable, new_columns: Mapping[str, np.ndarray], keep=None) -> NpTable:
    out = dict(t) if keep is None else {k: t[k] for k in keep}
    out.update(new_columns)
    return out


def fk_join(left: NpTable, right: NpTable, left_key: str, right_key: str,
            rprefix: str = "") -> NpTable:
    rk = right[right_key]
    lk = left[left_key]
    idx_map = {int(k): i for i, k in enumerate(rk)}
    matches = np.array([idx_map.get(int(k), -1) for k in lk])
    keep = matches >= 0
    src = matches[keep]
    out = {k: v[keep] for k, v in left.items()}
    for name, col in right.items():
        out_name = rprefix + name
        if out_name == left_key and name == right_key:
            continue
        out[out_name] = col[src]
    return out


def cross_join(a: NpTable, b: NpTable, aprefix: str = "", bprefix: str = "") -> NpTable:
    na = len(next(iter(a.values()))) if a else 0
    nb = len(next(iter(b.values()))) if b else 0
    out = {}
    for name, col in a.items():
        out[aprefix + name] = np.repeat(col, nb, axis=0)
    for name, col in b.items():
        reps = (na,) + (1,) * (col.ndim - 1)
        out[bprefix + name] = np.tile(col, reps)
    return out


def aggregate(t: NpTable, key: str, aggs: Mapping[str, Tuple[str, str]]) -> NpTable:
    keys = t[key]
    uniq = np.unique(keys)
    out: NpTable = {key: uniq.astype(np.int32)}
    for out_name, (kind, in_col) in aggs.items():
        vals = []
        for u in uniq:
            sel = keys == u
            if kind == "count":
                vals.append(float(sel.sum()))
            else:
                x = t[in_col][sel].astype(np.float64)
                vals.append({"sum": x.sum(axis=0), "mean": x.mean(axis=0),
                             "min": x.min(axis=0), "max": x.max(axis=0)}[kind])
        out[out_name] = np.array(vals, dtype=np.float32)
    return out


def union_all(a: NpTable, b: NpTable) -> NpTable:
    return {k: np.concatenate([a[k], b[k]], axis=0) for k in a}


def canonical(t: NpTable) -> NpTable:
    if not t:
        return t
    n = len(next(iter(t.values())))
    if n == 0:
        return t
    keys = []
    for name in sorted(t):
        arr = t[name]
        if arr.ndim == 1:
            keys.append(np.round(arr.astype(np.float64), 4))
        else:
            keys.append(np.round(arr.astype(np.float64).sum(axis=tuple(range(1, arr.ndim))), 4))
    order = np.lexsort(tuple(reversed(keys)))
    return {k: v[order] for k, v in t.items()}
