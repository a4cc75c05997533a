"""AdamW over a tree of tensors (nested dicts and lists), the port of
``repro.train.optim``.

The update is the reference's, step for step, so that a training step of
either package gives the same parameters: a global-norm clip
``sqrt(sum g^2 + 1e-12)`` scaled by ``min(1, clip / gnorm)``, bias
correction in float32, ``delta + weight_decay * p``, and moments kept in
float32 or, with ``moment_dtype="bfloat16"``, in bfloat16 with the math in
float32. ``torch.optim.AdamW`` with ``clip_grad_norm_`` is another function
(its clip divides by ``norm + 1e-6``).

The update is functional: ``init(params)`` gives the state and
``update(grads, state, params)`` returns new parameters and a new state;
nothing is written in place. On a (data, model) mesh the trees are each
rank's blocks (``models.sharding.train_specs``) and the clip's norm is the
whole tree's (``global_sq_norm``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists, tuples and
    NamedTuples (and of trees of the same structure, leaf by leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def global_sq_norm(tree, specs, mesh) -> torch.Tensor:
    """The sum of squares of a tree whose leaves are this rank's blocks
    under ``specs`` (a tree of the same dict keys; a leaf's spec names the
    mesh axes it is split over), the same float32 0-d tensor on every rank:
    each leaf's squares summed over the axes that split it, a leaf held
    whole counted once (a sum over every rank would count it data x model
    times). Leaves split alike are summed locally first, then reduced once
    a group."""
    from repro_torch.core import mesh as mesh_util
    from repro_torch.models.sharding import spec_axes
    groups: dict = {}

    def add(g, spec):
        axes = spec_axes(spec)
        sq = torch.sum(torch.square(g.to(torch.float32)))
        groups[axes] = groups[axes] + sq if axes in groups else sq

    tree_map(add, tree, specs)
    total = None
    for axes in sorted(groups):
        part = groups[axes]
        for a in axes:
            part = mesh_util.all_reduce_sum(part, mesh, a)
        total = part if total is None else total + part
    return total


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, on the parameters' device
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = 1.0
    moment_dtype: str = "float32"  # or "bfloat16": half the moments' memory

    def _mdt(self) -> torch.dtype:
        return torch.bfloat16 if self.moment_dtype == "bfloat16" else torch.float32

    def init(self, params) -> AdamWState:
        device = tree_leaves(params)[0].device
        zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=self._mdt()), params)
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          mu=zeros(), nu=zeros())

    def update(self, grads, state: AdamWState, params, mesh=None, specs=None):
        """New (params, state). On ``mesh`` the three trees are this rank's
        blocks under ``specs`` (``models.sharding.train_specs``): the
        update is elementwise on them, and the clip's norm is the whole
        tree's (``global_sq_norm``)."""
        step = state.step + 1
        f32 = torch.float32
        if self.grad_clip is not None:
            sq = (sum(torch.sum(torch.square(g.to(f32))) for g in tree_leaves(grads))
                  if mesh is None else global_sq_norm(grads, specs, mesh))
            gnorm = torch.sqrt(sq + 1e-12)
            scale = torch.clamp(self.grad_clip / gnorm, max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        b1, b2, mdt = self.b1, self.b2, self._mdt()
        mu = tree_map(lambda m, g: (b1 * m.to(f32) + (1 - b1) * g.to(f32)).to(mdt),
                      state.mu, grads)
        nu = tree_map(lambda v, g: (b2 * v.to(f32)
                                    + (1 - b2) * torch.square(g.to(f32))).to(mdt),
                      state.nu, grads)
        t = step.to(f32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=t.device), t)

        def upd(p, m, v):
            mhat = m.to(f32) / bc1
            vhat = v.to(f32) / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(f32)
            return (p.to(f32) - self.lr * delta).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamWState(step=step, mu=mu, nu=nu)
