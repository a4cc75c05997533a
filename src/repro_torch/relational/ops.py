"""Relational operators over static-shape columnar Tables.

Semantics (mask-aware):
  - ``filter``     : valid &= predicate(valid rows); never changes capacity.
  - ``compact``    : physically gathers valid rows to the front of a (usually
                     smaller) static capacity, so downstream per-row ML
                     compute is proportional to *capacity*, not to live rows.
  - ``project``    : adds/overwrites columns (row-aligned compute).
  - ``fk_join``    : inner equi-join where the right side's key is unique
                     (dimension table). Output capacity == left capacity.
  - ``cross_join`` : cartesian product, capacity Na*Nb.
  - ``aggregate``  : group-by over one key column with sum/mean/count/min/max,
                     output capacity = static group bound.
  - ``union_all``  : concatenation.

Every sort is stable (``torch.argsort(..., stable=True)``), as ``jnp.argsort``
is, so ties keep their input order and results match the JAX package row for
row. Buffers made inside an operator are filled out of place (``scatter``,
``index_add``, ``scatter_reduce``): ``torch.func.vmap`` refuses in-place
writes of batched values into them, and the serving tier vmaps the plans.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch

from repro_torch.relational.table import Table

_INT_SENTINEL = torch.iinfo(torch.int32).max


# ---------------------------------------------------------------------------
# filter / compact / project
# ---------------------------------------------------------------------------

def filter_(t: Table, mask: torch.Tensor) -> Table:
    """Keep rows where ``mask`` holds. ``mask`` is bool[capacity]."""
    return Table(columns=t.columns, valid=t.valid & mask)


def compact(t: Table, capacity: int) -> Table:
    """Gather valid rows to the front of a new static ``capacity``.

    If there are more valid rows than ``capacity`` the extra rows are dropped
    (the optimizer only compacts when its selectivity bound says this cannot
    happen).
    """
    n = t.capacity
    # stable order: valid rows first, preserving relative order.
    order = torch.argsort((~t.valid).to(torch.int32), stable=True)
    if capacity <= n:
        take = order[:capacity]
    else:
        take = torch.cat([order, order.new_zeros(capacity - n)])
    cols = {k: v[take] for k, v in t.columns.items()}
    rank = torch.arange(capacity, device=t.device)
    valid = rank < torch.clamp(t.num_valid(), max=capacity)
    if capacity > n:
        valid = valid & (rank < n)
    return Table(columns=cols, valid=valid)


def project(t: Table, new_columns: Mapping[str, torch.Tensor],
            keep: Sequence[str] | None = None) -> Table:
    """Add/overwrite columns; optionally restrict the kept input columns."""
    base = t if keep is None else t.select(keep)
    return base.with_columns(dict(new_columns))


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def fk_join(left: Table, right: Table, left_key: str, right_key: str,
            rprefix: str = "") -> Table:
    """Inner FK equi-join: every left row matches <=1 valid right row.

    Right keys are assumed unique among valid rows (dimension table). Output
    rows align with left rows; unmatched left rows become invalid.
    """
    lk = left[left_key].to(torch.int32)
    rk = right[right_key].to(torch.int32)
    rk_m = torch.where(right.valid, rk, _INT_SENTINEL)
    order = torch.argsort(rk_m, stable=True)
    sorted_keys = rk_m[order].contiguous()
    pos = torch.searchsorted(sorted_keys, lk.contiguous())
    pos_c = torch.clamp(pos, 0, rk.shape[0] - 1)
    matched = (sorted_keys[pos_c] == lk) & (lk != _INT_SENTINEL)
    src = order[pos_c]
    cols = dict(left.columns)
    for name, col in right.columns.items():
        out_name = rprefix + name
        if out_name == left_key and name == right_key:
            continue  # join key identical; keep left copy
        cols[out_name] = col[src]
    valid = left.valid & matched & right.valid[src]
    return Table(columns=cols, valid=valid)


def cross_join(a: Table, b: Table, aprefix: str = "", bprefix: str = "") -> Table:
    """Cartesian product. Row (ia, ib) lands at index ia * Nb + ib."""
    na, nb = a.capacity, b.capacity
    cols: Dict[str, torch.Tensor] = {}
    for name, col in a.columns.items():
        cols[aprefix + name] = col.repeat_interleave(nb, dim=0)
    for name, col in b.columns.items():
        cols[bprefix + name] = col.repeat((na,) + (1,) * (col.ndim - 1))
    valid = a.valid.repeat_interleave(nb) & b.valid.repeat(na)
    return Table(columns=cols, valid=valid)


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------

_AGG_KINDS = ("sum", "mean", "count", "min", "max")


def _dense_group_ids(keys: torch.Tensor, valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map arbitrary int32 keys (valid rows) to dense ids [0..G).

    Returns (gid[N] with invalid rows mapped to a padding id, rep_key[N]
    giving the key value for each dense id slot, num_groups scalar).
    """
    n = keys.shape[0]
    km = torch.where(valid, keys.to(torch.int32), _INT_SENTINEL)
    order = torch.argsort(km, stable=True)
    s = km[order]
    newseg = torch.cat([torch.ones_like(s[:1], dtype=torch.bool), s[1:] != s[:-1]])
    newseg = newseg & (s != _INT_SENTINEL)
    gid_sorted = torch.cumsum(newseg.to(torch.int64), 0) - 1
    gid_sorted = torch.where(s == _INT_SENTINEL, n, gid_sorted)  # pad bucket
    inv = torch.zeros_like(order).scatter(0, order, torch.arange(n, device=keys.device))
    gid = gid_sorted[inv]
    num_groups = newseg.sum(dtype=torch.int32)
    # representative key per dense id (first occurrence in sorted order);
    # slot n takes the writes JAX's mode="drop" scatter drops
    rep = torch.full((n + 1,), _INT_SENTINEL, dtype=torch.int32, device=keys.device)
    rep = rep.scatter(0, torch.where(newseg, gid_sorted, n), s)
    return gid, rep[:n], num_groups


def _segment(x: torch.Tensor, seg: torch.Tensor, num_segments: int,
             reduce: str) -> torch.Tensor:
    """``jax.ops.segment_{sum,min,max}``: empty segments give 0, +inf, -inf."""
    shape = (num_segments,) + tuple(x.shape[1:])
    if reduce == "sum":
        return torch.zeros(shape, dtype=x.dtype, device=x.device).index_add(0, seg, x)
    init = float("inf") if reduce == "amin" else float("-inf")
    idx = seg.reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
    out = torch.full(shape, init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, idx, x, reduce=reduce, include_self=True)


def aggregate(t: Table, key: str, aggs: Mapping[str, Tuple[str, str]],
              num_groups: int) -> Table:
    """Group by ``key``; ``aggs`` maps out_name -> (kind, in_column).

    kind in {sum, mean, count, min, max}. Output capacity = ``num_groups``
    (static upper bound on distinct keys; rows beyond the bound are dropped).
    The group key is emitted under its original name.
    """
    gid, rep, ng = _dense_group_ids(t[key], t.valid)
    if rep.shape[0] < num_groups:  # more group slots than input rows
        rep = torch.cat([rep, rep.new_full((num_groups - rep.shape[0],),
                                           _INT_SENTINEL)])
    seg = torch.where(gid < num_groups, gid, num_groups)  # overflow+padding bucket
    ones = t.valid.to(torch.float32)
    counts = _segment(ones, seg, num_groups + 1, "sum")[:num_groups]
    cols: Dict[str, torch.Tensor] = {key: rep[:num_groups]}
    for out_name, (kind, in_col) in aggs.items():
        if kind not in _AGG_KINDS:
            raise ValueError(f"unknown agg kind {kind}")
        if kind == "count":
            cols[out_name] = counts
            continue
        x = t[in_col].to(torch.float32)
        mask = t.valid.reshape((-1,) + (1,) * (x.ndim - 1))
        if kind in ("sum", "mean"):
            xm = torch.where(mask, x, 0.0)
            s = _segment(xm, seg, num_groups + 1, "sum")[:num_groups]
            if kind == "mean":
                denom = torch.clamp(counts, min=1.0)
                s = s / denom.reshape((-1,) + (1,) * (x.ndim - 1))
            cols[out_name] = s
        elif kind == "min":
            xm = torch.where(mask, x, float("inf"))
            cols[out_name] = _segment(xm, seg, num_groups + 1, "amin")[:num_groups]
        else:  # max
            xm = torch.where(mask, x, float("-inf"))
            cols[out_name] = _segment(xm, seg, num_groups + 1, "amax")[:num_groups]
    valid = torch.arange(num_groups, device=t.device) < torch.clamp(ng, max=num_groups)
    return Table(columns=cols, valid=valid)


# ---------------------------------------------------------------------------
# set ops
# ---------------------------------------------------------------------------

def union_all(a: Table, b: Table) -> Table:
    if set(a.columns) != set(b.columns):
        raise ValueError("union_all requires identical schemas")
    cols = {k: torch.cat([a.columns[k], b.columns[k]], dim=0) for k in a.columns}
    return Table(columns=cols, valid=torch.cat([a.valid, b.valid]))
