"""Device-mesh utilities of the multi-device paths, on ``torch.distributed``.

The port of ``repro.core.mesh``. The JAX package runs one controller over a
``jax.sharding.Mesh`` and moves data with ``shard_map`` collectives; here
every rank of a ``torch.distributed`` process group runs the same program
on the same replicated inputs (multi-controller, as JAX runs on several
hosts), and the collectives are explicit calls on the mesh's group:

* ``data_mesh``      : a 1-D ``DeviceMesh`` over the ranks, dimension name
                       ``"data"`` (the batch/data axis; no model axis).
* ``batch_ways``     : total rank count over the mesh's batch axes.
* ``shard_spec``     : the batch spec of ``models.sharding.batch_spec``:
                       shard only when the batch divides the rank count.
* ``can_shard``      : more than one rank on the batch axes AND the fitting
                       policy sharded.
* ``mesh_signature`` : the mesh's part of a compiled-plan cache key
                       (``data=8``, the reference's string).
* ``shard_batch``    : each rank runs its ``B/ways`` slice of a stacked
                       batch, then the outputs are all-gathered back.
* ``shard_replicated``: a partitioned plan body over replicated inputs and
                       outputs; the data moves through the ``PRepartition``
                       collectives inside it (``all_gather_rows``,
                       ``all_reduce_sum``, ``rank_of``).

``jax.lax.axis_index`` becomes the rank in the mesh's group,
``all_gather(..., tiled=True)`` an all-gather into one tensor on dim 0,
``psum`` an all-reduce with SUM (in the tensor's own type, bfloat16
included), ``psum_scatter`` a reduce-scatter and ``pmax`` an all-reduce
with MAX. Training differentiates through the collectives: ``sum_over``,
``copy_to``, ``gather_rows`` and ``split_rows`` are autograd functions
whose backward is the collective's transpose. Masks cross a collective as ``uint8`` (an
all-gather) or ``int32`` (a sum), never ``bool``. gloo takes CUDA tensors
as they are (it copies them through the host itself), so several ranks can
share one card over gloo; NCCL refuses two ranks on one GPU.

A mesh needs the default process group (``torch.distributed
.init_process_group``, or ``repro_torch.testing.spawn_ranks``); every
group made here takes that group's timeout, so a rank that never joins a
collective fails the others within it instead of hanging them.

The collectives take one mesh axis or a tuple of them (the LM's batch
axes ``("pod", "data")``): over a tuple they run one axis after the other,
the first axis the slowest (all-gathers from the last axis out,
reduce-scatters from the first in), which is the joint group's row-major
order. Every collective adds the bytes of its result to a counter by kind
and axis (``collective_bytes``), as the reference's dry run sums the result
shapes of the collectives in its HLO; ``launch.dryrun`` reads it.

Also here: the intra-query partition arithmetic of the PartSpec layer
(``row_block``, ``padded_capacity``, ``hash_bucket``) and the mesh builders
``make_host_mesh`` and ``make_production_mesh`` (``launch.mesh`` re-exports
both). The production mesh is the reference's 256 or 512 chips; launch
analysis builds it over a fake world of that many ranks in one process
(``launch.dryrun``).
"""
from __future__ import annotations

import datetime
import math
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch.kernels.common import resolve_device
from repro_torch.models.sharding import axis_size, batch_axes, batch_spec, block_index

DATA_AXIS = "data"
Axis = Union[str, Tuple[str, ...]]  # one mesh axis, or several taken together

# bytes of every collective's result since the last reset, by (kind, axis);
# the kinds are the reference's HLO names (``launch/hlo_stats.py``)
_COLLECTIVE_BYTES: Dict[Tuple[str, str], int] = defaultdict(int)


def reset_collective_bytes() -> None:
    _COLLECTIVE_BYTES.clear()


def collective_bytes() -> Dict[Tuple[str, str], int]:
    """The bytes counted since the last reset, keyed by (kind, axis):
    ``all-gather``, ``all-reduce`` and ``reduce-scatter`` count their
    result tensor (the gathered rows, the reduced tensor, the rank's
    block)."""
    return dict(_COLLECTIVE_BYTES)


def _count(kind: str, axis: str, nbytes: int) -> None:
    _COLLECTIVE_BYTES[(kind, axis)] += int(nbytes)


def _axes(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _require_group() -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call init_process_group "
            "(or run under repro_torch.testing.spawn_ranks) before building a mesh")


def group_timeout(group=None) -> datetime.timedelta:
    """The timeout of ``group`` (default: the world group): what a
    collective on it waits for a rank that does not join. torch's fake
    backend (``torch.testing._internal.distributed.fake_pg``, launch
    analysis) keeps no options and waits for no one: its groups take
    torch's default timeout."""
    pg = group if group is not None else dist.group.WORLD
    if dist.get_backend(pg) == "fake":
        return dist.default_pg_timeout
    for dev in ("cpu", "cuda"):
        try:
            return pg._get_backend(torch.device(dev)).options._timeout
        except (RuntimeError, AttributeError):
            continue
    raise RuntimeError("the process group exposes no timeout")


def _device_mesh(groups, device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    if len(names) == 1:
        return DeviceMesh.from_group(groups[0], device_type, mesh_dim_names=names)
    mesh = torch.arange(dist.get_world_size(), dtype=torch.int).reshape(shape)
    return DeviceMesh.from_group(groups, device_type, mesh=mesh, mesh_dim_names=names)


def data_mesh(n_devices: Optional[int] = None, *, device=None,
              axis: str = DATA_AXIS):
    """A 1-D mesh of ``n_devices`` ranks (default: all of them) on
    ``device``'s type (``cuda`` unless the caller names one; raises without
    CUDA otherwise).

    With fewer ranks than the world holds, the ranks split into replicas of
    ``n_devices`` consecutive ranks (``n_devices`` must divide the world
    size), and each rank's mesh is its own replica: under several
    controllers every rank must belong to the mesh it runs on. ``axis``
    must be a batch axis name (``models.sharding.batch_axes``), otherwise
    the mesh would silently never shard anything."""
    dev = resolve_device(device)
    if axis not in ("pod", DATA_AXIS):
        raise ValueError(
            f"axis {axis!r} is not a recognized batch axis "
            f"('pod'/'{DATA_AXIS}'): can_shard would always be False")
    _require_group()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} out of range for {world} rank(s)")
    if world % n:
        raise ValueError(f"n_devices={n} does not divide the {world} ranks "
                         "into whole replicas")
    if n == world:
        group = dist.group.WORLD
    else:
        group, _ = dist.new_subgroups(n, timeout=group_timeout())
    return _device_mesh([group], dev.type, (n,), (axis,))


def batch_ways(mesh) -> int:
    """Total shard count over the mesh's batch axes (pod x data)."""
    ways = 1
    for a in batch_axes(mesh):
        ways *= axis_size(mesh, a)
    return ways


def shard_spec(mesh, batch_size: int) -> tuple:
    """Batch-axis spec under the divisibility-fitting policy."""
    return batch_spec(mesh, batch_size)


def can_shard(mesh, batch_size: int) -> bool:
    """True iff the mesh would actually split ``batch_size``: more than one
    rank on the batch axes and the fitting policy sharded (batch divides
    the rank count). Everything else falls back to the single-device
    vmapped program."""
    if mesh is None or batch_ways(mesh) <= 1:
        return False
    return any(ax is not None for ax in shard_spec(mesh, batch_size))


def mesh_signature(mesh) -> str:
    """The mesh's contribution to a compiled-plan cache key: axis layout and
    per-axis size (rank identity doesn't change the program)."""
    return "x".join(f"{a}={axis_size(mesh, a)}" for a in mesh.mesh_dim_names)


# ---------------------------------------------------------------------------
# collectives over one mesh axis
# ---------------------------------------------------------------------------

def _group(mesh, axis: str):
    _require_group()
    return mesh.get_group(axis)


def rank_of(mesh, axis: Axis = DATA_AXIS) -> int:
    """This rank's index along ``axis`` (``jax.lax.axis_index``); over a
    tuple of axes its row-major index, the first axis the slowest."""
    _require_group()
    return block_index(mesh, _axes(axis))[0]


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it crosses a collective: contiguous, a mask as uint8."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def all_gather_rows(x: torch.Tensor, mesh, axis: Axis = DATA_AXIS) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in rank order
    (``jax.lax.all_gather(x, axis, axis=0, tiled=True)``)."""
    w = _wire(x)
    for a in reversed(_axes(axis)):
        out = w.new_empty((w.shape[0] * axis_size(mesh, a),) + tuple(w.shape[1:]))
        dist.all_gather_into_tensor(out, w, group=_group(mesh, a))
        _count("all-gather", a, out.numel() * out.element_size())
        w = out
    return w.to(x.dtype)


def all_reduce_sum(x: torch.Tensor, mesh, axis: Axis = DATA_AXIS) -> torch.Tensor:
    """The sum of every rank's ``x`` (``jax.lax.psum``); a mask sums as
    int32 and comes back as ``count > 0``."""
    w = x.to(torch.int32) if x.dtype == torch.bool else x.clone(
        memory_format=torch.contiguous_format)
    for a in _axes(axis):
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=_group(mesh, a))
        _count("all-reduce", a, w.numel() * w.element_size())
    return w > 0 if x.dtype == torch.bool else w


def all_reduce_max(x: torch.Tensor, mesh, axis: Axis = DATA_AXIS) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` (``jax.lax.pmax``)."""
    w = x.clone(memory_format=torch.contiguous_format)
    for a in _axes(axis):
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=_group(mesh, a))
        _count("all-reduce", a, w.numel() * w.element_size())
    return w


def reduce_scatter_rows(x: torch.Tensor, mesh, axis: Axis = DATA_AXIS) -> torch.Tensor:
    """This rank's block of rows of the sum of every rank's ``x`` over
    ``axis`` (``jax.lax.psum_scatter(x, axis, tiled=True)``): dim 0 must
    divide over the axis. gloo takes float32 and bfloat16, CUDA tensors
    included (torch 2.11 on the H100)."""
    w = x.contiguous()
    for a in _axes(axis):
        out = w.new_empty((w.shape[0] // axis_size(mesh, a),) + tuple(w.shape[1:]))
        dist.reduce_scatter_tensor(out, w, op=dist.ReduceOp.SUM, group=_group(mesh, a))
        _count("reduce-scatter", a, out.numel() * out.element_size())
        w = out
    return w


# ---------------------------------------------------------------------------
# differentiable collectives (training on a mesh)
# ---------------------------------------------------------------------------
#
# The in-place collectives above carry no gradient. Training runs the
# reference's sharded program under autograd, where each collective's
# backward is its transpose (what JAX differentiates ``psum``,
# ``all_gather`` and a ``shard_map`` boundary into). Not
# ``torch.distributed.nn.functional``: its all-reduce's backward sums the
# upstream gradient over the ranks, so a loss computed alike on every rank
# would get n times its gradient.

class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, ctx.axis), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, sum_grads):
        ctx.mesh, ctx.axis, ctx.sum_grads = mesh, axis, sum_grads
        return all_gather_rows(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            return reduce_scatter_rows(g, ctx.mesh, ctx.axis), None, None, None
        return _block_rows(g, ctx.mesh, ctx.axis).clone(), None, None, None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _block_rows(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g, ctx.mesh, ctx.axis), None, None


def _block_rows(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    blk = x.shape[0] // axis_size(mesh, axis)
    return x.narrow(0, rank_of(mesh, axis) * blk, blk)


def sum_over(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis``; the gradient passes
    through as it is (``psum`` of partial results into a replicated
    output, as the MoE's combine over ``model``)."""
    return _SumOver.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``axis``. For a replicated
    input that each rank of ``axis`` uses only in part (its experts, its
    tokens): each rank's gradient is then a partial sum."""
    return _CopyTo.apply(x, mesh, axis)


def gather_rows(x: torch.Tensor, mesh, axis: Axis = DATA_AXIS,
                sum_grads: bool = True) -> torch.Tensor:
    """``all_gather_rows`` with a gradient: the rank's block of the
    gradient, summed over ``axis`` first (a reduce-scatter) when each rank
    computed a partial gradient (``sum_grads``, the data-parallel case),
    else taken as it is (every rank holds the whole gradient)."""
    return _GatherRows.apply(x, mesh, axis, sum_grads)


def split_rows(x: torch.Tensor, mesh, axis: Axis = DATA_AXIS) -> torch.Tensor:
    """This rank's block of ``x``'s rows over ``axis``, a whole tensor on
    every rank; the gradient is all-gathered back to the whole rows."""
    return _SplitRows.apply(x, mesh, axis)


def agree(value, mesh, axis: str = DATA_AXIS, what: str = "plan") -> None:
    """Raise on every rank unless all ranks along ``axis`` hold an equal
    ``value`` (a string): the plans that ranks run must match, collective
    for collective."""
    group = _group(mesh, axis)
    got = [None] * axis_size(mesh, axis)
    dist.all_gather_object(got, value, group=group)
    if any(g != got[0] for g in got):
        diff = sorted({i for i, g in enumerate(got) if g != got[0]})
        raise RuntimeError(f"ranks {diff} disagree with rank 0 about the {what}")


def broadcast_from_first(value, mesh, axis: str = DATA_AXIS):
    """Rank 0's ``value`` on every rank along ``axis``."""
    group = _group(mesh, axis)
    box = [value]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def shard_batch(fn: Callable, mesh) -> Callable:
    """Split a stacked-batch function over the mesh's batch axes.

    ``fn`` takes / returns nested dicts and tuples of tensors whose leading
    axis is the stacked batch; each rank runs ``fn`` on its
    ``batch/ways`` slice and the outputs are all-gathered back to the full
    batch, so every rank returns the whole result. Callers must have
    checked ``can_shard``. Weights and other closed-over tensors are
    replicated (every rank holds its own)."""
    (axis,) = batch_axes(mesh)
    ways = axis_size(mesh, axis)

    def run(stacked):
        i = rank_of(mesh, axis)

        def take(x):
            blk = x.shape[0] // ways
            return x[i * blk:(i + 1) * blk]

        out = fn(tree_map(take, stacked))
        return tree_map(lambda y: all_gather_rows(y, mesh, axis), out)

    return run


def shard_replicated(fn: Callable, mesh) -> Callable:
    """A *partitioned plan body* over the mesh: inputs and outputs are
    replicated (every rank holds the full catalog tables and returns the
    full result), and all data movement happens in the explicit
    ``PRepartition`` collectives inside ``fn``. The single-oversized-query
    counterpart of ``shard_batch``: no stacked batch axis is split, the
    *operators* are partitioned."""
    _group(mesh, batch_axes(mesh)[0])  # raises without a process group
    return fn


# ---------------------------------------------------------------------------
# intra-query partition arithmetic (the PartSpec layer's shared helpers)
# ---------------------------------------------------------------------------

def row_block(capacity: int, ways: int) -> int:
    """Per-device row-block size of a ``ways``-way row partition of a
    ``capacity``-row table: ``ceil(capacity / ways)``; non-dividing
    capacities pad the tail with invalid rows (``padded_capacity``)."""
    if ways < 1:
        raise ValueError(f"ways must be >= 1, got {ways}")
    return -(-int(capacity) // ways)


def padded_capacity(capacity: int, ways: int) -> int:
    """Smallest multiple of ``row_block`` covering ``capacity``: the shape
    row-partitioned blocks re-concatenate to before the trailing padding
    rows (all invalid, all at the tail) are sliced off."""
    return row_block(capacity, ways) * ways


def hash_bucket(keys, ways: int) -> torch.Tensor:
    """Device bucket of each (integer) join key: ``key mod ways``, int32.

    The single bucketing function of hash-partitioned joins: both join
    sides and the cost model must agree on it. ``torch.remainder`` is
    non-negative for positive ``ways`` regardless of key sign, as
    ``jnp.mod`` is."""
    k = torch.as_tensor(keys).to(torch.int32)
    return torch.remainder(k, ways).to(torch.int32)


# ---------------------------------------------------------------------------
# mesh builders (repro_torch.launch.mesh re-exports them)
# ---------------------------------------------------------------------------

def _grid_mesh(shape: tuple, names: tuple, device_type: str):
    """A mesh of ``shape`` over the default group's ranks, rank ``i`` at the
    row-major position ``i`` (the last axis the fastest); each axis's
    groups enumerated once (every line of the grid along that axis) with
    the world group's timeout."""
    _require_group()
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the group has {n}")
    timeout = group_timeout()
    grid = torch.arange(n).reshape(shape)
    groups = []
    for i, size in enumerate(shape):
        lines = grid.movedim(i, -1).reshape(-1, size).tolist()
        groups.append(dist.new_subgroups_by_enumeration(lines, timeout=timeout)[0])
    return _device_mesh(groups, device_type, tuple(shape), tuple(names))


def make_host_mesh(data: Optional[int] = None, model: int = 1, *, pod: Optional[int] = None,
                   device=None):
    """A (data, model) mesh over the ranks already in the default group
    (``data * model`` must be the world size), rank ``d * model + m`` at
    (d, m); with ``pod`` a (pod, data, model) mesh of ``pod * data *
    model`` ranks, rank ``(p * data + d) * model + m`` at (p, d, m). Each
    dimension's groups take the world group's timeout."""
    dev = resolve_device(device)
    _require_group()
    n = dist.get_world_size()
    data = data if data is not None else max(n // (model * (pod or 1)), 1)
    if pod is None:
        return _grid_mesh((data, model), ("data", "model"), dev.type)
    return _grid_mesh((pod, data, model), ("pod", "data", "model"), dev.type)


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: one pod of 256 ranks (16 data x 16
    model) or two (2 pod x 16 data x 16 model), over an initialised world
    of exactly that many ranks, real or fake (``launch.dryrun`` starts a
    fake one in its own process). Raises on any other world."""
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    return _grid_mesh(shape, names, resolve_device(device).type)
