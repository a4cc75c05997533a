"""Backend-parameterized expression evaluator (middle-level IR).

``eval_expr(e, t, registry, xp=torch|np)``: ``t`` is anything supporting
``t[col] -> array``, a relational Table (tensors) or a plain dict of numpy
arrays; ``xp`` is the array namespace. ML calls always run the port's own
torch atoms: on the numpy path their arguments go in as CPU tensors and the
result comes back as numpy.

Constants evaluate to 0-dim values (a 0-dim float32 tensor on the torch
path, which broadcasts against columns on any device) and rely on
broadcasting; callers that need a column-shaped result (e.g. Project
outputs) broadcast explicitly via ``as_column``.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.mlfuncs.registry import Registry


def _as_bool(v, xp):
    if xp is torch:
        return torch.as_tensor(v).to(torch.bool)
    return np.asarray(v).astype(bool)


def eval_expr(e: ir.Expr, t: Any, registry: Registry, xp=torch):
    if isinstance(e, ir.Col):
        return t[e.name]
    if isinstance(e, ir.Const):
        if xp is torch:
            return torch.tensor(e.value, dtype=torch.float32)
        return np.float32(e.value)
    if isinstance(e, ir.BinOp):
        a = eval_expr(e.a, t, registry, xp)
        b = eval_expr(e.b, t, registry, xp)
        a, b = _align(a, b)
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
        if e.op == "/":
            eps = 1e-9 if xp is torch else np.float32(1e-9)  # keeps float32
            return a / xp.where(b == 0, eps, b)
        raise ValueError(e.op)
    if isinstance(e, ir.Cmp):
        a = eval_expr(e.a, t, registry, xp)
        b = eval_expr(e.b, t, registry, xp)
        a, b = _align(a, b)
        return {"<": a < b, ">": a > b, "<=": a <= b, ">=": a >= b,
                "==": a == b, "!=": a != b}[e.op]
    if isinstance(e, ir.BoolOp):
        vals = [_as_bool(eval_expr(a, t, registry, xp), xp) for a in e.args]
        if e.op == "and":
            return functools.reduce(xp.logical_and, vals)
        if e.op == "or":
            return functools.reduce(xp.logical_or, vals)
        if e.op == "not":
            return xp.logical_not(vals[0])
        raise ValueError(e.op)
    if isinstance(e, ir.IsIn):
        a = eval_expr(e.a, t, registry, xp)
        if xp is torch:
            a = a.to(torch.int32)
            out = torch.zeros_like(a, dtype=torch.bool)
        else:
            a = np.asarray(a).astype(np.int32)
            out = np.zeros_like(a, dtype=bool)
        for v in e.values:
            out = out | (a == v)
        return out
    if isinstance(e, ir.IfExpr):
        c = _as_bool(eval_expr(e.cond, t, registry, xp), xp)
        return xp.where(c, eval_expr(e.t, t, registry, xp),
                        eval_expr(e.f, t, registry, xp))
    if isinstance(e, ir.Call):
        fn = registry.get(e.fn)
        args = [torch.as_tensor(eval_expr(a, t, registry, xp)) for a in e.args]
        out = fn.apply(*args)
        if out.ndim == 2 and out.shape[1] == 1:
            out = out[:, 0]  # dim-1 vectors are scalar columns
        return out if xp is torch else out.numpy()
    raise TypeError(type(e))


def _align(a, b):
    """Insert the broadcast axis when mixing vector [N, d] and scalar [N]
    columns; true scalars (ndim 0) broadcast natively."""
    a_nd = getattr(a, "ndim", 0)
    b_nd = getattr(b, "ndim", 0)
    if a_nd == 2 and b_nd == 1:
        return a, b[:, None]
    if a_nd == 1 and b_nd == 2:
        return a[:, None], b
    return a, b


def as_column(val, capacity: int, device=None):
    """Broadcast a scalar evaluation result to a [capacity] column (Table
    columns must have the row axis) on ``device``."""
    if getattr(val, "ndim", 0) != 0:
        return val
    if isinstance(val, torch.Tensor):
        dev = device if device is not None else val.device
        if val.device.type == "cpu":  # a constant: read on the host, no sync
            return torch.full((capacity,), val.item(), dtype=val.dtype, device=dev)
        # on the card, .item() would wait for the device (and a CUDA-graph
        # capture refuses it): broadcast there instead
        return val.to(dev).expand(capacity).clone()
    return np.full((capacity,), val)


def has_call(e: ir.Expr) -> bool:
    if isinstance(e, ir.Call):
        return True
    return any(has_call(c) for c in e.children())
