"""Fault-tolerant checkpointing, the port of ``repro.train.checkpoint``,
in its on-disk format.

A checkpoint is a directory ``step_<8 digits>`` holding ``shard_0.npz`` and
a JSON manifest carrying step, config hash, mesh descriptor, keys, shapes
and dtypes. Keys are the reference's tree paths joined by ``/``: dict keys,
sequence indices and NamedTuple field names (``0/blocks/wq``,
``1/mu/embed``, ``1/step``, ``2/0``). bfloat16 is stored as its ``uint16``
bits (npz has no bf16). The config hash is ``sha1(repr(cfg))[:16]``, and
the port's configs print as the reference's, so a checkpoint carries
weights and optimizer state between the two packages. Saves are atomic
(write to a temporary directory, then rename) and keep the last ``keep``
steps.

Trees are nested dicts, lists, tuples and NamedTuples of tensors, numpy
arrays or Python scalars. ``restore`` rebuilds the template's structure
with each tensor leaf in the template leaf's type and on its device.

On a (data, model) mesh the state is each rank's training placement
(``models.sharding.train_specs``): a leaf whose tree path ends in a param's
path (``0/blocks/wq``, ``1/mu/embed``) is that param's block.
``save(..., mesh=)`` gathers every such leaf whole, so the file is the
one a single device writes, and the mesh's first rank writes it;
``restore(..., mesh=)`` cuts each rank's blocks for the mesh it is given
(the reference's ``shardings=``), which may differ from the one that saved.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


def _items(tree) -> Optional[list]:
    """(path entry, child) pairs of an inner node, None for a leaf."""
    if hasattr(tree, "_fields"):  # NamedTuple: its field names
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _map_with_path(fn: Callable, tree, path: str = ""):
    items = _items(tree)
    if items is None:
        return fn(path, tree)
    out = [_map_with_path(fn, v, f"{path}/{k}" if path else k) for k, v in items]
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), out))
    return type(tree)(out)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}

    def put(key, leaf):
        flat[key], dtypes[key] = _to_numpy(leaf)

    _map_with_path(put, tree)
    return flat, dtypes


def config_hash(cfg) -> str:
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:16]


def _param_specs(cfg, mesh) -> Dict[str, tuple]:
    """The training placement's spec of each param, by its path."""
    from repro_torch.models import lm, sharding
    flat: Dict[str, tuple] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v

    walk(sharding.train_specs(cfg, lm.param_shapes(cfg), mesh), "")
    return flat


def _placed(fn: Callable, tree, cfg, mesh):
    """``fn(leaf, spec)`` on every tensor leaf whose path ends in a param's
    path (``_param_specs``); the other leaves as they are."""
    if cfg is None:
        raise ValueError("a checkpoint on a mesh needs cfg (the params' placement)")
    specs = _param_specs(cfg, mesh)

    def one(path, leaf):
        parts = path.split("/")
        spec = next((specs[p] for p in ("/".join(parts[i:]) for i in range(len(parts)))
                     if p in specs), None)
        if spec is None or not isinstance(leaf, torch.Tensor) or leaf.ndim != len(spec):
            return leaf
        return fn(leaf, spec)

    return _map_with_path(one, tree)


def save(ckpt_dir: str, step: int, state: Any, cfg=None,
         mesh_descr: str = "", keep: int = 3, mesh=None) -> str:
    """Atomic checkpoint save. Returns the checkpoint path. On ``mesh``
    every rank of it calls this alike: the placed leaves are gathered
    whole, the mesh's first rank writes, and all return after the write."""
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.models import sharding
        state = _placed(lambda w, sp: sharding.whole_leaf(w, sp, mesh), state, cfg, mesh)
        if dist.get_rank() == int(mesh.mesh.flatten()[0]):
            _write(ckpt_dir, step, state, cfg, mesh_descr, keep)
        dist.barrier()
        return os.path.join(ckpt_dir, f"step_{step:08d}")
    return _write(ckpt_dir, step, state, cfg, mesh_descr, keep)


def _write(ckpt_dir: str, step: int, state: Any, cfg, mesh_descr: str, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        flat, dtypes = _flatten(state)
        np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
        manifest = {
            "step": step,
            "config_hash": config_hash(cfg) if cfg is not None else None,
            "mesh": mesh_descr,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and
             os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            cfg=None, mesh=None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (whole leaves; the latest
    step unless ``step`` is given); refuses a checkpoint whose config hash
    differs from ``cfg``'s. With ``mesh`` (and ``cfg``) each param leaf,
    and each moment, comes back as this rank's block of it on ``mesh``.
    Returns (state, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if cfg is not None and manifest["config_hash"] not in (None, config_hash(cfg)):
        raise ValueError("checkpoint config hash mismatch — refusing to load "
                         f"({manifest['config_hash']} != {config_hash(cfg)})")
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        def leaf(key, tmpl):
            arr = data[key]
            bf16 = manifest["dtypes"].get(key) == "bfloat16"
            if not isinstance(tmpl, (torch.Tensor, np.ndarray)):  # a Python scalar
                return type(tmpl)(arr.item())
            if list(arr.shape) != list(tmpl.shape):
                raise ValueError(f"{key}: shape {arr.shape} != {tuple(tmpl.shape)}")
            if isinstance(tmpl, np.ndarray):
                return arr.astype(tmpl.dtype)
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if bf16
                 else torch.from_numpy(arr))
            return t.to(device=tmpl.device, dtype=tmpl.dtype)

        state = _map_with_path(leaf, template)
    if mesh is not None:
        from repro_torch.models import sharding
        state = _placed(lambda w, sp: sharding.place_leaf(w, sp, mesh), state, cfg, mesh)
    return state, step
