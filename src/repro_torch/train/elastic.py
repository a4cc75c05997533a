"""Elastic scaling: the mesh for the surviving device count, the port of
``repro.train.elastic``'s planning.

Policy: the model axis is preserved (its degree is baked into the layer
shardings and kernel block shapes); the data-parallel degree shrinks or
grows to ``devices // model_parallel``, and devices beyond data * model
are left idle (reported). Moving training state onto the new mesh
(``reshard_state``) waits for training on a mesh; the checkpoint path
(save, restart over the survivors, restore) covers the full restart.
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist

from repro_torch.core.mesh import make_host_mesh


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
