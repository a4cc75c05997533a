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

The reference places its arrays with GSPMD, which partitions every product
by its weight's placement. Here every rank of the mesh runs the same
program (multi-controller), so placement is explicit and covers what the
sharded bodies consume, nothing more (``model_leaves``):

* the decoders and the hybrid (``tensor_parallel``; ``tp_leaves`` names
  the leaves as ``group/leaf`` paths) take ``param_pspecs``'s ``model``
  entries, and ``models.lm`` computes them tensor parallel (Megatron's
  pair, ``core.mesh.copy_to`` before a column-split product and
  ``sum_over`` after a row-split one):
  - GQA and M-RoPE: ``wq`` (columns) and ``wo`` (rows) by query head;
    ``w_gate`` and ``w_in`` (columns), ``w_out`` (rows);
  - MLA: ``wq_b`` and ``wkv_b`` (columns) and ``wo`` (rows) by head; the
    shared experts ``sh_gate`` and ``sh_in`` (columns), ``sh_out`` (rows);
  - the hybrid: the Mamba-2 layers' ``w_in``, ``w_z`` (columns) and
    ``conv_w`` (channels) by SSM head, ``w_out`` by row; the shared
    block's attention and MLP as a GQA decoder's;
  - ``embed`` by vocab row.
  Whole, as in the reference: ``wk``, ``wv``, MLA's ``wq_a``, ``q_ln``,
  ``wkv_a`` and ``kv_ln``, the Mamba-2 layers' ``w_bc``, ``w_dt`` and the
  per-head vectors ``A_log``, ``D_skip`` and ``dt_bias``, the router and
  the norms. One difference from the reference: where the heads do not
  divide over ``model`` (``n_heads % model != 0``), the leaves split by
  head stay whole over ``model`` and their attention (or Mamba-2 layer)
  runs whole on every rank, with the hybrid's ``conv`` and ``ssm`` states
  whole over ``model`` too; the reference's ``_fit`` would cut them
  mid-head wherever their width divides (the smoke configs on (1, 8): 4
  heads, ``wq`` 64 columns, MLA's ``wq_b`` 96, the Mamba-2 ``d_in`` 128);
* every family's experts (``e_gate``, ``e_in``, ``e_out``) take their block
  over ``model`` where ``moe_block`` splits them;
* xLSTM and the encoder-decoder keep every other leaf whole and compute
  it replicated over ``model``.

``serve_specs`` is that placement (no ``data`` entries: serving holds whole
weights over the batch axes; the reference's prefill does too but for
deepseek-v2, and its decode keeps every FSDP config's ``data`` entries,
``launch.specs``);
``shard_params`` cuts it from whole leaves and ``lm.init_params(mesh=)``
draws it. The cache is the rank's block (``serve_cache_specs``): K/V
(MLA's ``ckv``/``kpe``) over the batch axes, ``data`` or (``pod``,
``data``), when ``batch_spec`` shards the batch, and over ``model`` by
slot; the hybrid's ``conv`` and ``ssm`` states over the batch axes, and
over ``model`` by channel and by head where its Mamba-2 leaves split;
``lm.init_cache(mesh=)`` and ``lm.prefill(mesh=)`` allocate only that
block, ``shard_cache`` cuts it from a whole cache.

Training on a mesh keeps its own placement (``train_specs``): the same
``model`` entries, and on every leaf but the experts its ``data`` entries
(FSDP configs); ``place`` cuts it from whole leaves and ``unplace``
gathers it back (checkpoints, ``train.elastic.reshard_state``, tests).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

EXPERTS = ("e_gate", "e_in", "e_out")
CACHE_ROWS = ("k", "v", "ckv", "kpe")  # the S-sharded cache of a mesh's decode
_STACKED_GROUPS = ("blocks", "enc_blocks", "cross", "mlstm", "slstm", "mamba")


def axis_size(mesh, axis) -> int:
    """Number of ranks along the mesh dimension named ``axis``, or over a
    tuple of them."""
    if not isinstance(axis, str):
        n = 1
        for a in axis:
            n *= axis_size(mesh, a)
        return n
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

def block_index(mesh, axes: tuple, rank: Optional[int] = None) -> tuple:
    """(this rank's block, or that of the mesh's global rank ``rank``, the
    block count) over the mesh axes ``axes``, row-major (the first axis is
    the slowest)."""
    at = None if rank is None else dict(
        zip(mesh.mesh_dim_names, (mesh.mesh == rank).nonzero()[0].tolist()))
    idx, ways = 0, 1
    for a in axes:
        n = axis_size(mesh, a)
        idx, ways = idx * n + (mesh.get_local_rank(a) if at is None else at[a]), ways * n
    return idx, ways


def block_view(x, spec: tuple, mesh, axes: tuple, rank: Optional[int] = None):
    """A view of this rank's block of ``x`` (or of the global rank
    ``rank``'s) along every dimension whose spec entry names one of
    ``axes`` (the other entries are left whole)."""
    for dim, ax in enumerate(spec):
        names = tuple(a for a in (ax or ()) if a in axes)
        if names:
            idx, ways = block_index(mesh, names, rank)
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


def tensor_parallel(cfg) -> bool:
    """Whether the family's dense leaves split over ``model`` on a mesh
    (``tp_leaves``): the decoders (``kind`` dense or moe: GQA, M-RoPE and
    MLA attention) and the hybrid. xLSTM and the encoder-decoder keep those
    leaves whole."""
    return cfg.kind in ("dense", "moe", "hybrid")


def tp_leaves(cfg) -> tuple:
    """(the leaves split by head, the other leaves split, the whole leaves
    whose gradient is partial) of a ``tensor_parallel`` family over
    ``model``, as ``group/leaf`` paths (``embed`` at the top), with
    ``param_pspecs``'s ``model`` entries: the one table of the split. By
    head: the columns of ``wq`` (MLA: ``wq_b`` and ``wkv_b``) and the rows
    of ``wo``; in the hybrid also the Mamba-2 layers' ``w_in``, ``w_z`` and
    ``conv_w`` (channels) and ``w_out`` (rows), whose heads are
    ``cfg.n_heads`` as the shared block's are. The others: the dense FFN
    (``w_gate``, ``w_in`` by column, ``w_out`` by row), MLA's shared experts
    (``sh_gate``, ``sh_in``, ``sh_out``), the shared block's MLP, and
    ``embed`` by vocab row. Partial (``partial_leaves``): the leaves that
    stay whole while the consumers of their outputs split by head, so that
    each rank computes a part of their gradient: ``wk`` and ``wv`` (a rank
    reads the KV heads of its query heads), MLA's latent projections
    ``wq_a``, ``q_ln``, ``wkv_a`` and ``kv_ln``, and the Mamba-2 layers'
    ``w_bc`` (B and C feed the rank's heads), ``w_dt``, ``dt_bias``,
    ``A_log`` and ``D_skip`` (sliced to them)."""
    if not tensor_parallel(cfg):
        return (), (), ()
    if cfg.kind == "hybrid":
        return (("mamba/w_in", "mamba/w_z", "mamba/conv_w", "mamba/w_out",
                 "shared_attn/wq", "shared_attn/wo"),
                ("shared_attn/w_gate", "shared_attn/w_in", "shared_attn/w_out", "embed"),
                ("mamba/w_bc", "mamba/w_dt", "mamba/dt_bias", "mamba/A_log", "mamba/D_skip",
                 "shared_attn/wk", "shared_attn/wv"))
    mla = cfg.attn == "mla"
    heads = ("wq_b", "wkv_b", "wo") if mla else ("wq", "wo")
    partial = ("wq_a", "q_ln", "wkv_a", "kv_ln") if mla else ("wk", "wv")
    mo = cfg.moe
    ffn = (() if mo is not None and not mo.n_shared else
           ("gate", "in", "out") if cfg.act == "swiglu" else ("in", "out"))
    prefix = "sh_" if mo is not None else "w_"
    return (tuple(f"blocks/{n}" for n in heads),
            tuple(f"blocks/{prefix}{n}" for n in ffn) + ("embed",),
            tuple(f"blocks/{n}" for n in partial))


def model_leaves(cfg, mesh) -> frozenset:
    """The leaves (``group/leaf`` paths) whose ``param_pspecs`` entry over
    ``model`` the port keeps on ``mesh`` (where ``_fit`` leaves one): the
    experts where ``moe_block`` splits them; for ``tensor_parallel``
    configs ``tp_leaves``'s, those split by head only where the heads
    divide over ``model`` (never mid-head)."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return frozenset()
    keep = {f"blocks/{n}" for n in EXPERTS} if sharded_experts(cfg, mesh) else set()
    heads, other, _ = tp_leaves(cfg)
    keep.update(other)
    if cfg.n_heads % axis_size(mesh, "model") == 0:
        keep.update(heads)
    return frozenset(keep)


def heads_split(cfg, mesh) -> bool:
    """Whether the leaves split by head (``tp_leaves``) are blocks of more
    than one ``model`` rank on ``mesh``."""
    heads = tp_leaves(cfg)[0]
    return (bool(heads) and heads[0] in model_leaves(cfg, mesh)
            and axis_size(mesh, "model") > 1)


def partial_leaves(cfg, mesh) -> frozenset:
    """The whole leaves of ``tp_leaves`` whose gradient each ``model`` rank
    computes a part of on ``mesh`` (where the heads split), to be summed
    over ``model``."""
    return frozenset(tp_leaves(cfg)[2]) if heads_split(cfg, mesh) else frozenset()


def _walk(fn, tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``tree`` with each leaf ``v`` at path ``p`` (``group/leaf``) replaced
    by ``fn(p, v)``."""
    return {k: _walk(fn, v, f"{prefix}{k}/") if isinstance(v, dict) else fn(prefix + k, v)
            for k, v in tree.items()}


def _check_block(name: str, w, spec: tuple, mesh, whole: tuple) -> None:
    want = block_shape(whole, spec, mesh)
    if tuple(w.shape) != want:
        raise ValueError(f"{name}: a leaf of shape {tuple(w.shape)}, neither the whole "
                         f"{whole} nor this rank's block {want} under {spec}")


def shard_params(params: Dict[str, Any], cfg, mesh) -> Dict[str, Any]:
    """Whole params -> this rank's under ``serve_specs``: each leaf with a
    ``model`` entry cut to the rank's block over ``model`` (a leaf that
    already is that block stays; any other shape raises), every other leaf
    the same tensor."""
    if mesh is None:
        return params
    from repro_torch.models import lm
    shapes = lm.param_shapes(cfg)
    specs = serve_specs(cfg, shapes, mesh)

    def cut(name, w, spec, whole):
        if not spec_axes(spec):
            return w
        if tuple(w.shape) == whole:
            return local_block(w, spec, mesh, ("model",))
        _check_block(name, w, spec, mesh, whole)
        return w

    def walk(tree, sp, sh, path):
        return {k: walk(v, sp[k], sh[k], f"{path}{k}/") if isinstance(v, dict)
                else cut(path + k, v, sp[k], tuple(sh[k])) for k, v in tree.items()}

    return walk(params, specs, shapes, "")


def sharded_cache(cfg) -> bool:
    """Whether the family's decode step takes the mesh (GQA and MLA
    decoders, the hybrid's shared block): the encoder-decoder and xLSTM
    decode on one device in the reference, with their cache whole."""
    return cfg.kind in ("dense", "moe", "hybrid")


def check_slots(slots: int, mesh) -> None:
    """Raises ValueError when a cache of ``slots`` slots does not divide
    over the ``model`` ranks, as the reference's ``shard_map`` refuses
    such a cache."""
    ways = axis_size(mesh, "model")
    if slots % ways:
        raise ValueError(f"shard_cache: {slots} cache slots do not divide over "
                         f"{ways} model ranks")


def shard_cache(cache: Dict[str, Any], cfg, mesh) -> Dict[str, Any]:
    """Whole cache -> this rank's block under ``serve_cache_specs``: K/V
    (MLA's ``ckv``/``kpe``) cut to the rank's rows over the batch axes when
    ``batch_spec`` shards them and to its slots over ``model``, the hybrid's
    ``conv`` and ``ssm`` states to its rows and (where its Mamba-2 layers
    split) its channels or heads; every other entry the same tensor. Raises
    ValueError when the slots do not divide over ``model``, as the
    reference's ``shard_map`` refuses such a cache."""
    if mesh is None or not sharded_cache(cfg):
        return cache
    rows = [k for k in CACHE_ROWS if k in cache]
    batch, slots = cache[rows[0]].shape[1:3]
    check_slots(slots, mesh)
    specs = serve_cache_specs(cfg, cache, mesh, batch)
    return {k: local_block(v, specs[k], mesh, ("pod", "data", "model"))
            if spec_axes(specs[k]) else v for k, v in cache.items()}


def serve_specs(cfg, shapes: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Where prefill, decode and ``Server(mesh=)`` keep each leaf of the
    params (``shard_params``, ``lm.init_params(mesh=)``): ``param_pspecs``'s
    ``model`` entries on the leaves of ``model_leaves`` (the experts where
    ``moe_block`` splits them; the tensor-parallel leaves of the decoders
    and the hybrid, ``tp_leaves``, those split by head only where the heads
    divide), every other dim whole. No ``data`` entries: serving holds
    whole weights over the batch axes (the reference's prefill keeps
    deepseek-v2's FSDP ``data`` entries and its decode every FSDP config's,
    ``launch.specs``)."""
    keep = model_leaves(cfg, mesh)
    return _walk(lambda path, sp: tuple(ax if path in keep and ax and "model" in ax else None
                                        for ax in sp), param_pspecs(cfg, shapes, mesh))


def serve_cache_specs(cfg, cache: Dict[str, Any], mesh, batch: int) -> Dict[str, Any]:
    """Where a decode step on ``mesh`` keeps each entry of the cache
    (``shard_cache``, ``lm.init_cache(mesh=)``), for the families whose
    decode takes the mesh: ``cache_pspecs``'s on K/V (MLA's ``ckv`` and
    ``kpe``); the hybrid's ``conv`` and ``ssm`` states by rows as
    ``cache_pspecs`` places them, and over ``model`` by channel (``conv``)
    and head (``ssm``) where its Mamba-2 leaves split (``model_leaves``;
    whole over ``model`` where the heads do not divide, with the leaves);
    every other entry whole."""
    specs = cache_pspecs(cfg, cache, mesh, batch)
    if not sharded_cache(cfg):
        return {k: (None,) * len(sp) for k, sp in specs.items()}
    ssm = "mamba/w_in" in model_leaves(cfg, mesh)

    def keep(k, sp):
        if k in CACHE_ROWS:
            return sp
        if k in ("conv", "ssm"):
            return tuple(None if ax == ("model",) and not ssm else ax for ax in sp)
        return (None,) * len(sp)

    return {k: keep(k, sp) for k, sp in specs.items()}


def block_shape(shape, spec: tuple, mesh) -> tuple:
    """This rank's block of a leaf of ``shape`` under ``spec``: each dim
    over the product of its axes' sizes, rounded up where it does not
    divide (``NamedSharding(mesh, spec).shard_shape(shape)``)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-d // axis_size(mesh, ax)) if ax else d for d, ax in zip(shape, spec))


def to_shape_dtype(tree: Dict[str, Any], mesh, specs: Dict[str, Any]) -> Dict[str, Any]:
    """Launch analysis's inputs (the reference's ``ShapeDtypeStruct``s with
    a ``NamedSharding``): each leaf (a tensor, or anything with ``shape``
    and ``dtype``) becomes a ``meta`` tensor of this rank's block under its
    spec (``block_shape``), which it carries as ``.spec``."""
    def leaf(x, sp):
        t = torch.empty(block_shape(tuple(x.shape), sp, mesh), dtype=x.dtype, device="meta")
        t.spec = tuple(sp)
        return t

    return _zip_map(leaf, tree, specs)


# ---------------------------------------------------------------------------
# the training placement
# ---------------------------------------------------------------------------

def train_specs(cfg, shapes: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Where training on ``mesh`` keeps each leaf of the params (and of
    the AdamW moments, which take the params' placement, as the
    reference's ``AdamWState`` takes ``pspecs``): ``serve_specs``'s
    ``model`` entries (the tensor-parallel leaves, the experts where
    ``moe_block`` splits them) and ``param_pspecs``'s ``data`` entries on
    every leaf but the experts (a ``cfg.fsdp`` leaf holds the rank's block
    of the dim it puts on ``data``, ``embed`` and the stacked blocks
    included). A leaf split both ways (FSDP and tensor parallel) holds one
    block of each dim; ``lm`` gathers the ``data`` dim at its use and keeps
    the ``model`` block."""
    keep = model_leaves(cfg, mesh)

    def entry(path, ax):
        if ax is None:
            return None
        if "model" in ax:
            return ax if path in keep else None
        return ax if "data" in ax and path.rsplit("/", 1)[-1] not in EXPERTS else None

    return _walk(lambda path, sp: tuple(entry(path, ax) for ax in sp),
                 param_pspecs(cfg, shapes, mesh))


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
