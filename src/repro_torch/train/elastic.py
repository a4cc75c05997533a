"""Elastic scaling: the mesh for the surviving device count, the port of
``repro.train.elastic``'s planning.

Policy: the model axis is preserved (its degree is baked into the layer
shardings and kernel block shapes); the data-parallel degree shrinks or
grows to ``devices // model_parallel``, and devices beyond data * model
are left idle (reported). ``reshard_state`` moves training state onto
the new mesh's blocks; the checkpoint path (save, restart over the
survivors, ``checkpoint.restore(mesh=)``) covers the full restart.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch.distributed as dist

from repro_torch.core.mesh import make_host_mesh
from repro_torch.models import sharding
from repro_torch.train.optim import AdamWState


def plan_new_mesh(n_devices: int, model_parallel: int) -> Tuple[int, int, int]:
    """Returns (data, model, idle) for the surviving device count."""
    model = min(model_parallel, n_devices)
    data = max(n_devices // model, 1)
    idle = n_devices - data * model
    return data, model, idle


def remesh(model_parallel: int, *, device=None):
    """The (data, model) mesh of ``plan_new_mesh`` over the ranks of the
    default process group (the survivors, once the launcher has started
    the group anew over them), and the idle count. A torch.distributed mesh
    holds every rank of its group, so a plan that leaves ranks idle raises
    ValueError: start the group over data * model ranks."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("remesh: no torch.distributed process group")
    data, model, idle = plan_new_mesh(dist.get_world_size(), model_parallel)
    if idle:
        raise ValueError(f"remesh: {idle} of {dist.get_world_size()} ranks would idle; "
                         f"start the group over {data * model} ranks")
    return make_host_mesh(data, model, device=device), idle


def reshard_state(state: Any, cfg, shapes, new_mesh, mesh=None) -> Any:
    """Move ``(params, opt_state)`` onto ``new_mesh``'s blocks
    (``sharding.train_specs``; the moments take the params' placement,
    the step count stays whole), as the reference's ``jax.device_put`` with
    the new shardings. ``mesh``: the mesh the state is on now; every rank
    of it calls this alike, and each leaf is all-gathered whole over it,
    then cut to the rank's new block. ``mesh=None``: the leaves are whole
    already, as a survivor holds them once it has gathered or restored
    them, and the group may have been started anew over fewer ranks.
    ``opt_state`` may be None. ``shapes``: ``lm.param_shapes(cfg)``."""
    new = sharding.train_specs(cfg, shapes, new_mesh)
    old = None if mesh is None else sharding.train_specs(cfg, shapes, mesh)

    def move(tree):
        whole = tree if old is None else sharding.unplace(tree, old, mesh)
        return sharding.place(whole, new, new_mesh)

    params, opt_state = state
    if opt_state is not None:
        opt_state = AdamWState(step=opt_state.step, mu=move(opt_state.mu),
                               nu=move(opt_state.nu))
    return move(params), opt_state
