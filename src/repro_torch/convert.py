"""Carries state across from the JAX package in plain numpy structures.

The port never imports ``repro``; a caller that holds JAX objects (a test)
extracts plain structures from them and hands those over:

- a table is a column dict of numpy arrays plus a bool valid mask;
- a catalog is a dict ``name -> (columns, valid)``;
- an ML function is a dict ``{"name", "n_inputs", "out", "nodes",
  "selectivity_hint"}`` whose nodes are ``{"id", "kind", "params",
  "backend", "args"}`` dicts, params as numpy arrays or Python scalars;
- a logical plan tree is nested ``{"node": class name, "fields": {...}}``
  dicts, tuples and scalars (node uids included, so ``phys`` keys hold);
- a physical side table is ``uid -> {"mode", "backend", "n_tiles"}``;
- an LM's params are the JAX param tree as nested dicts of numpy arrays
  (``np.asarray`` of a bf16 JAX array is an ``ml_dtypes.bfloat16`` array).

Backend names map one to one: ``jnp`` -> ``torch``, ``pallas`` -> ``kernel``.
"""
from __future__ import annotations

from typing import Any, Iterable, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.kernels.common import resolve_device
from repro_torch.mlfuncs.functions import Atom, MLFunction, MLGraph, MLNode
from repro_torch.mlfuncs.registry import Registry
from repro_torch.relational.table import Table

BACKENDS = {"jnp": "torch", "pallas": "kernel"}


def backend(name: str) -> str:
    return BACKENDS.get(name, name)


def table(columns: Mapping[str, np.ndarray], valid: np.ndarray,
          device=None) -> Table:
    return Table.from_columns(dict(columns), valid=np.asarray(valid, bool),
                              device=device)


def catalog(tables: Mapping[str, Tuple[Mapping[str, np.ndarray], np.ndarray]],
            device=None) -> ir.Catalog:
    cat = ir.Catalog()
    for name, (columns, valid) in tables.items():
        cat.add(name, table(columns, valid, device))
    return cat


def ml_function(fn: Mapping[str, Any]) -> MLFunction:
    nodes = [MLNode(id=int(n["id"]),
                    atom=Atom(n["kind"], dict(n["params"]), backend(n["backend"])),
                    args=tuple((r[0], int(r[1])) for r in n["args"]))
             for n in fn["nodes"]]
    graph = MLGraph(nodes=nodes, out=int(fn["out"]), n_inputs=int(fn["n_inputs"]))
    return MLFunction(name=fn["name"], graph=graph, n_inputs=int(fn["n_inputs"]),
                      selectivity_hint=fn.get("selectivity_hint"))


def registry(fns: Iterable[Mapping[str, Any]]) -> Registry:
    reg = Registry()
    for fn in fns:
        reg.register(ml_function(fn))
    return reg


def ir_node(plain: Any) -> Any:
    """An expression or relational node of ``core.ir`` from its plain form."""
    if isinstance(plain, dict):
        cls = getattr(ir, plain["node"])
        if not isinstance(cls, type) or not issubclass(cls, (ir.Expr, ir.RelNode)):
            raise ValueError(f"not an IR node: {plain['node']}")
        return cls(**{k: ir_node(v) for k, v in plain["fields"].items()})
    if isinstance(plain, (tuple, list)):
        return tuple(ir_node(v) for v in plain)
    return plain


def plan(root: Mapping[str, Any], fns: Iterable[Mapping[str, Any]],
         phys: Mapping[str, Mapping[str, Any]] = ()) -> ir.Plan:
    cfgs = {uid: ir.PhysConfig(mode=c["mode"], backend=backend(c["backend"]),
                               n_tiles=int(c["n_tiles"]))
            for uid, c in dict(phys).items()}
    return ir.Plan(root=ir_node(root), registry=registry(fns), phys=cfgs)


def lm_params_from_numpy(tree: Mapping[str, Any], device=None,
                         dtype: torch.dtype | None = None) -> dict:
    """The port's LM param dict from the JAX param tree as numpy arrays.
    ``torch.from_numpy`` refuses ``ml_dtypes.bfloat16``, so every leaf goes
    through float32, which holds bf16 exactly, and then to ``dtype``
    (default: bf16 for bf16 leaves, else float32)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        want = dtype or (torch.bfloat16 if bf16 else torch.float32)
        return t.to(device=dev, dtype=want)

    return {k: lm_params_from_numpy(v, dev, dtype) if isinstance(v, Mapping)
            else leaf(v) for k, v in tree.items()}


EMBEDDER_PARTS = ("m2v", "q2v", "latency_q2v", "latency_head")


def _flat(tree: Any, prefix: str = "") -> dict:
    """A nested dict/list tree as ``{"blocks.0.qkv.w": leaf}``, the names
    of the port's module parameters."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (Mapping, list, tuple)):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def embedder_from_numpy(tree: Mapping[str, Any], device=None):
    """The port's ``QueryEmbedder`` from the JAX one's four param trees as
    numpy (``m2v``, ``q2v``, ``latency_q2v``, ``latency_head``) and its
    ``one_model`` flag. The port's linear weights are ``[din, dout]`` as the
    reference's, so every leaf carries over as it is."""
    from repro_torch.core.optimizer import init_embedder
    emb = init_embedder(0, device=device)
    for part in EMBEDDER_PARTS:
        state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
                 for k, v in _flat(tree[part]).items()}
        getattr(emb, part).load_state_dict(state, strict=True)
    emb.one_model = bool(tree["one_model"])
    return emb
