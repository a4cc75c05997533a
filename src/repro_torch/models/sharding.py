"""Sharding policy of the LM's (data, model) mesh, ported from
``repro.models.sharding``: batch over (pod, data); vocab, attention-head,
ffn and expert dims over ``model``; KV projections replicated over
``model`` (the cache itself is S-sharded at decode); FSDP configs also
shard the d_model dim of large weights over ``data``.

A spec is a plain tuple with one entry per dimension: a tuple of mesh axis
names the dimension is split over, or ``None`` where it is replicated (the
reference's ``PartitionSpec``). The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions;
``param_pspecs`` and ``cache_pspecs`` read only its shape.

The reference places its arrays with GSPMD. Here every rank of the mesh
runs the same program (multi-controller), so placement is explicit and
covers what the sharded bodies consume, nothing more: ``shard_params``
cuts the experts (``e_gate``, ``e_in``, ``e_out``) to the rank's block over
``model``; ``shard_cache`` cuts the attention cache (``k``/``v``, MLA's
``ckv``/``kpe``) to the rank's rows over ``data`` (when ``batch_spec``
shards the batch) and slots over ``model``. Every other leaf and state
(the hybrid's ``conv`` and ``ssm`` included) stays whole on every rank and
is computed replicated.

Training on a mesh keeps its own placement (``train_specs``): FSDP configs
hold the rank's block of each leaf's ``data`` dim, the experts their block
over ``model``; ``place`` cuts it from whole leaves and ``unplace`` gathers
it back (checkpoints, ``train.elastic.reshard_state``, tests).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

EXPERTS = ("e_gate", "e_in", "e_out")
CACHE_ROWS = ("k", "v", "ckv", "kpe")  # the S-sharded cache of a mesh's decode
_STACKED_GROUPS = ("blocks", "enc_blocks", "cross", "mlstm", "slstm", "mamba")


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along the mesh dimension named ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in (mesh.mesh_dim_names or ()))


def batch_spec(mesh, batch: int) -> tuple:
    """Shard batch over (pod, data) when divisible; else replicate."""
    axes = batch_axes(mesh)
    ways = 1
    for a in axes:
        ways *= axis_size(mesh, a)
    if batch % max(ways, 1) == 0 and batch >= ways:
        return (axes,)
    return (None,)


def _leaf_spec(name: str, shape, cfg, stacked: bool) -> tuple:
    fs = ("data",) if cfg.fsdp else None
    tp = ("model",)

    def wrap(*dims):
        return ((None,) if stacked else ()) + dims

    if len(shape) - (1 if stacked else 0) <= 1:  # norms / small vectors
        return wrap(None)
    if name == "embed":
        return (tp, fs)
    if name in ("wq", "xq", "w_gate", "w_in", "sh_gate", "sh_in", "w_q",
                "w_k", "w_v", "w_o", "w_z", "w_gates", "r_gates", "wq_b",
                "wkv_b"):
        return wrap(fs, tp)
    if name in ("wk", "wv", "xk", "xv", "wq_a", "wkv_a", "w_bc", "w_dt"):
        return wrap(fs, None)
    if name in ("wo", "xo", "w_out", "sh_out"):
        return wrap(tp, fs)
    if name == "router":
        return wrap(fs, None)
    if name in ("e_gate", "e_in"):
        return wrap(tp, fs, None)
    if name == "e_out":
        return wrap(tp, None, fs)
    if name == "conv_w":
        return wrap(None, tp)
    return wrap(*([None] * (len(shape) - (1 if stacked else 0))))


def _fit(spec: tuple, shape, mesh) -> tuple:
    """Drop sharding on axes the dimension size can't divide evenly."""
    axes = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            out.append(None)
            continue
        ways = 1
        for a in ax:
            ways *= axis_size(mesh, a)
        out.append(ax if (ways and dim % ways == 0) else None)
    return tuple(out)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", leaf))


def param_pspecs(cfg, shapes: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Spec tree mirroring ``shapes`` (``lm.param_shapes(cfg)``, or a param
    tree: a leaf is a shape or a tensor)."""

    def walk(tree, group):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
            else:
                shape = _shape(v)
                out[k] = _fit(_leaf_spec(k, shape, cfg, group in _STACKED_GROUPS),
                              shape, mesh)
        return out

    return walk(shapes, "")


def cache_pspecs(cfg, cache: Dict[str, Any], mesh, batch: int) -> Dict[str, Any]:
    """KV caches: batch over data, S over model (flash-decode sharding);
    SSM states: batch over data, heads over model when divisible. ``cache``
    holds tensors (``meta`` ones will do) or anything with ``shape``."""
    b_ax = batch_spec(mesh, batch)[0]

    def spec(k, v):
        ndim = len(_shape(v))
        if k == "len":
            return ()
        if k in ("k", "v"):        # [L?, B, S, kv, hd]
            lead = (None,) if ndim == 5 else ()
            return lead + (b_ax, ("model",), None, None)
        if k in ("ckv", "kpe"):    # [L, B, S, d]
            return (None, b_ax, ("model",), None)
        if k == "conv":            # [L, B, W-1, d_in]
            return (None, b_ax, None, ("model",))
        if k == "ssm":             # [L, B, H, state, dh]
            tp = ("model",) if cfg.n_heads % axis_size(mesh, "model") == 0 else None
            return (None, b_ax, tp, None, None)
        if k == "mS":              # [L, B, H, dh, dh+1]
            return (None, b_ax, None, None, None)
        if k in ("sh", "sc", "sn"):  # [seg, B, D]
            return (None, b_ax, None)
        if k == "enc_h":           # [B, S_src, D]
            return (b_ax, None, None)
        return (None,) * ndim

    return {k: _fit(spec(k, v), _shape(v), mesh) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# placement on the ranks
# ---------------------------------------------------------------------------

def block_index(mesh, axes: tuple) -> tuple:
    """(this rank's block, the block count) over the mesh axes ``axes``,
    row-major (the first axis is the slowest)."""
    idx, ways = 0, 1
    for a in axes:
        n = axis_size(mesh, a)
        idx, ways = idx * n + mesh.get_local_rank(a), ways * n
    return idx, ways


def block_view(x, spec: tuple, mesh, axes: tuple):
    """A view of this rank's block of ``x`` along every dimension whose
    spec entry names one of ``axes`` (the other entries are left whole)."""
    for dim, ax in enumerate(spec):
        names = tuple(a for a in (ax or ()) if a in axes)
        if names:
            idx, ways = block_index(mesh, names)
            blk = x.shape[dim] // ways
            x = x.narrow(dim, idx * blk, blk)
    return x


def local_block(x, spec: tuple, mesh, axes: tuple):
    """``block_view`` copied into storage of its own, so the whole tensor
    can be freed."""
    return block_view(x, spec, mesh, axes).clone(memory_format=torch.contiguous_format)


def sharded_experts(cfg, mesh) -> bool:
    """Whether ``moe_block`` splits the experts over ``model`` on ``mesh``
    (the reference's branch): an MoE config, a ``model`` axis, and an
    expert count that divides its size."""
    return (mesh is not None and cfg.moe is not None
            and "model" in (mesh.mesh_dim_names or ())
            and cfg.moe.n_experts % axis_size(mesh, "model") == 0)


def shard_params(params: Dict[str, Any], cfg, mesh) -> Dict[str, Any]:
    """Params -> this rank's: the experts ([L?, E, ...]) cut to the rank's
    block over ``model`` where ``moe_block`` splits them (an expert leaf
    that already holds fewer than all the experts is this rank's and
    stays), every other leaf the same tensor."""
    if not sharded_experts(cfg, mesh):
        return params

    def cut(v):
        dim = v.ndim - 3
        if v.shape[dim] != cfg.moe.n_experts:
            return v
        return local_block(v, (None,) * dim + (("model",),), mesh, ("model",))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else cut(v) if k in EXPERTS else v
                for k, v in tree.items()}

    return walk(params)


def sharded_cache(cfg) -> bool:
    """Whether the family's decode step takes the mesh (GQA and MLA
    decoders, the hybrid's shared block): the encoder-decoder and xLSTM
    decode on one device in the reference, with their cache whole."""
    return cfg.kind in ("dense", "moe", "hybrid")


def shard_cache(cache: Dict[str, Any], cfg, mesh) -> Dict[str, Any]:
    """Whole cache -> this rank's: K/V (MLA's ``ckv``/``kpe``) cut to the
    rank's rows over ``data`` when ``batch_spec`` shards them and to its
    slots over ``model``; every other entry the same tensor. Raises
    ValueError when the slots do not divide over ``model``, as the
    reference's ``shard_map`` refuses such a cache."""
    if mesh is None or not sharded_cache(cfg):
        return cache
    rows = [k for k in CACHE_ROWS if k in cache]
    batch, slots = cache[rows[0]].shape[1:3]
    ways = axis_size(mesh, "model")
    if slots % ways:
        raise ValueError(f"shard_cache: {slots} cache slots do not divide over "
                         f"{ways} model ranks")
    specs = cache_pspecs(cfg, {k: cache[k] for k in rows}, mesh, batch)
    return dict(cache, **{k: local_block(cache[k], specs[k], mesh, ("data", "model"))
                          for k in rows})


# ---------------------------------------------------------------------------
# the training placement
# ---------------------------------------------------------------------------

def train_specs(cfg, shapes: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Where training on ``mesh`` keeps each leaf of the params (and of
    the AdamW moments, which take the params' placement, as the
    reference's ``AdamWState`` takes ``pspecs``): ``param_pspecs``'s
    ``data`` entries (a ``cfg.fsdp`` leaf holds the rank's block of the
    dim it puts on ``data``, ``embed`` and the stacked blocks included) on
    every leaf but the experts, and its ``model`` entries on the experts
    only, where ``moe_block`` splits them. Every other dim is whole: the
    port computes attention and the dense FFNs whole over ``model``."""
    split = sharded_experts(cfg, mesh)

    def keep(name, spec):
        want = ("model" if split else None) if name in EXPERTS else "data"
        return tuple(ax if ax is not None and want in ax else None for ax in spec)

    def walk(specs):
        return {k: walk(v) if isinstance(v, dict) else keep(k, v) for k, v in specs.items()}

    return walk(param_pspecs(cfg, shapes, mesh))


def spec_axes(spec: tuple) -> tuple:
    """The mesh axes a leaf's spec splits it over, in the spec's order."""
    return tuple(a for ax in spec if ax for a in ax)


def _zip_map(fn, tree: Dict[str, Any], specs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _zip_map(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
            for k, v in tree.items()}


def place_leaf(w, spec: tuple, mesh):
    """A whole leaf -> this rank's block under ``spec``, in storage of its
    own; a leaf its spec leaves whole is the same tensor."""
    axes = spec_axes(spec)
    return local_block(w, spec, mesh, axes) if axes else w


def whole_leaf(w, spec: tuple, mesh):
    """This rank's block under ``spec`` -> the whole leaf, on every rank
    (all-gathers over the axes ``spec`` names, in the same order on every
    rank; no gradient)."""
    if not spec_axes(spec):
        return w
    from repro_torch.core import mesh as mesh_util
    for dim, ax in enumerate(spec):
        for a in reversed(ax or ()):
            w = mesh_util.all_gather_rows(w.movedim(dim, 0), mesh, a).movedim(0, dim)
    return w.contiguous()


def place(tree: Dict[str, Any], specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Whole leaves -> this rank's blocks under ``specs`` (``train_specs``)."""
    return _zip_map(lambda w, sp: place_leaf(w, sp, mesh), tree, specs)


def unplace(tree: Dict[str, Any], specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The inverse of ``place``: every rank's blocks gathered back to the
    whole leaves, on every rank."""
    return _zip_map(lambda w, sp: whole_leaf(w, sp, mesh), tree, specs)


def batch_rows(mesh, n: int) -> Optional[slice]:
    """This rank's rows of a batch of ``n`` over the mesh's batch axes when
    ``n`` divides their rank count (more than one), else None (replicated):
    the reference's ``P(batch_axes)`` in_specs of its decode and MoE
    ``shard_map``s."""
    axes = batch_axes(mesh)
    idx, ways = block_index(mesh, axes)
    if ways <= 1 or n % ways:
        return None
    blk = n // ways
    return slice(idx * blk, (idx + 1) * blk)
