"""Atomic ML functions, computation graphs, and high-level ML functions.

An ``Atom`` is a batched primitive (operates on [N, d] / [N] columns). Every
atom exposes ``out_dim`` and ``flops_per_row`` so the query optimizer can read
tensor shapes and costs straight off the bottom-level IR (paper Sec. III-C).

``MLGraph`` is the bottom-level IR: nodes are atoms, edges are tensors. Graph
inputs are vector/scalar columns of the enclosing relation.

Parameters stay numpy arrays inside the IR, where the rules and the cost
policies read them; ``Atom.apply`` moves each to the input's device once and
keeps it in a small per-device cache on the atom.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.relational.table import as_tensor

Ref = Tuple[str, int]  # ('in', k) or ('node', node_id)


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "relu":
        return torch.relu(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form
    if kind == "softmax":
        return torch.softmax(x, dim=-1)
    if kind == "squared_relu":
        return torch.square(torch.relu(x))
    if kind == "identity":
        return x
    raise ValueError(f"unknown activation {kind}")


@dataclasses.dataclass
class Atom:
    """One atomic ML function instance (with bound parameters)."""

    kind: str
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    # execution backend, mutated by R4-2 (library replacement): 'torch'|'kernel'
    backend: str = "torch"
    # (param name, device) -> tensor; not copied by dataclasses.replace
    _on_device: Dict[Tuple[str, str], torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    # -- shape/flops introspection (dims: 0 means scalar/int column) ------
    def out_dim(self, in_dims: Sequence[int]) -> int:
        k, p = self.kind, self.params
        if k == "matmul":
            return int(p["w"].shape[1])
        if k == "bias":
            return in_dims[0]
        if k == "act":
            return in_dims[0]
        if k == "concat":
            return int(sum(max(d, 1) for d in in_dims))
        if k in ("cossim", "dot", "dist"):
            return 0
        if k == "embed":
            return int(p["table"].shape[1])
        if k == "scale":
            return in_dims[0]
        if k == "onehot":
            return int(p["num"])
        if k == "forest":
            return 0
        if k == "fused_dense":
            return int(p["w"].shape[1])
        if k == "binarize":
            return 0
        if k == "slice":
            return int(p["stop"] - p["start"])
        if k in ("add", "mul", "sqrt"):
            return in_dims[0]
        if k == "argmin":
            return 0
        if k == "const_vec":
            return int(np.asarray(p["value"]).shape[-1])
        raise ValueError(f"unknown atom kind {k}")

    def flops_per_row(self, in_dims: Sequence[int]) -> float:
        k, p = self.kind, self.params
        d = [max(x, 1) for x in in_dims] if in_dims else [1]
        if k == "matmul":
            w = p["w"]
            return 2.0 * w.shape[0] * w.shape[1]
        if k == "fused_dense":
            w = p["w"]
            return 2.0 * w.shape[0] * w.shape[1] + 2.0 * w.shape[1]
        if k in ("bias", "act", "scale", "add", "mul", "sqrt", "binarize", "argmin"):
            return float(d[0])
        if k == "concat":
            return float(sum(d))
        if k in ("cossim", "dist"):
            return 6.0 * d[0]
        if k == "dot":
            return 2.0 * d[0]
        if k == "embed":
            return float(p["table"].shape[1])  # gather cost proxy
        if k == "onehot":
            return float(p["num"])
        if k == "forest":
            return float(p["feat"].shape[0] * p["depth"] * 4)
        if k == "slice":
            return float(p["stop"] - p["start"])
        if k == "const_vec":
            return 0.0
        raise ValueError(f"unknown atom kind {k}")

    def param_bytes(self) -> int:
        total = 0
        for v in self.params.values():
            if isinstance(v, np.ndarray):
                total += int(np.prod(v.shape)) * v.dtype.itemsize
            elif isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
        return total

    def param(self, name: str, device) -> torch.Tensor:
        """Parameter ``name`` as a tensor on ``device`` (cached per device)."""
        key = (name, str(device))
        t = self._on_device.get(key)
        if t is None:
            t = as_tensor(self.params[name], device)
            self._on_device[key] = t
        return t

    # -- execution ---------------------------------------------------------
    def apply(self, *xs: torch.Tensor) -> torch.Tensor:
        k, p = self.kind, self.params
        dev = xs[0].device if xs else None
        if k == "matmul":
            x = xs[0] if xs[0].ndim == 2 else xs[0][:, None]
            return x @ self.param("w", dev)
        if k == "fused_dense":
            w, b = self.param("w", dev), self.param("b", dev)
            if self.backend == "kernel":
                from repro_torch.kernels.fused_dense import ops as fd_ops
                return fd_ops.fused_dense(xs[0].contiguous(), w, b, p["act"])
            return _act(p["act"], xs[0] @ w + b)
        if k == "bias":
            return xs[0] + self.param("b", dev)
        if k == "act":
            return _act(p["fn"], xs[0])
        if k == "concat":
            cols = [x if x.ndim == 2 else x[:, None].to(torch.float32) for x in xs]
            return torch.cat(cols, dim=-1)
        if k == "cossim":
            a, b = xs
            num = torch.sum(a * b, dim=-1)
            den = (torch.linalg.vector_norm(a, dim=-1)
                   * torch.linalg.vector_norm(b, dim=-1) + 1e-8)
            return num / den
        if k == "dot":
            return torch.sum(xs[0] * xs[1], dim=-1)
        if k == "dist":
            return torch.sqrt(torch.sum(torch.square(xs[0] - xs[1]), dim=-1) + 1e-12)
        if k == "embed":
            table = self.param("table", dev)
            ids = torch.clamp(xs[0].to(torch.int32), 0, table.shape[0] - 1)
            return table[ids.long()]
        if k == "scale":
            return (xs[0] - self.param("mean", dev)) / (self.param("std", dev) + 1e-8)
        if k == "onehot":
            # ids out of [0, num) give zero rows, as jax.nn.one_hot does
            ids = xs[0].to(torch.int32).long()
            return (ids[..., None] == torch.arange(p["num"], device=dev)).to(torch.float32)
        if k == "binarize":
            return (xs[0] > p["threshold"]).to(torch.float32)
        if k == "forest":
            return _forest_apply(self, xs[0])
        if k == "slice":
            return xs[0][:, p["start"]:p["stop"]]
        if k == "add":
            return xs[0] + xs[1]
        if k == "mul":
            return xs[0] * xs[1]
        if k == "sqrt":
            return torch.sqrt(torch.clamp(xs[0], min=0.0))
        if k == "argmin":
            return torch.argmin(xs[0], dim=-1).to(torch.float32)
        if k == "const_vec":
            v = self.param("value", dev)
            return v.expand((xs[0].shape[0],) + tuple(v.shape))
        raise ValueError(f"unknown atom kind {k}")


def _forest_apply(atom: Atom, x: torch.Tensor) -> torch.Tensor:
    """Array-form decision forest: complete binary trees of fixed depth.

    feat[T, 2^D-1] int32, thresh[T, 2^D-1] f32, leaf[T, 2^D] f32.
    Returns mean leaf value over trees (the ensemble vote).
    """
    dev = x.device
    feat, thresh, leaf = (atom.param(n, dev) for n in ("feat", "thresh", "leaf"))
    if atom.backend == "kernel":
        from repro_torch.kernels.decision_forest import ops as df_ops
        return df_ops.forest_predict(x.contiguous(), feat, thresh, leaf)
    depth = int(atom.params["depth"])
    n, t = x.shape[0], feat.shape[0]
    feat = feat.long().clamp(0, x.shape[1] - 1)
    node = torch.zeros((n, t), dtype=torch.long, device=dev)
    t_idx = torch.arange(t, device=dev)[None, :]
    for _ in range(depth):
        f = feat[t_idx, node]                          # [n, t]
        th = thresh[t_idx, node]
        xv = torch.gather(x, 1, f)                     # gather features
        node = 2 * node + 1 + (xv > th).long()
    leaf_idx = node - (2 ** depth - 1)
    lv = leaf[t_idx, leaf_idx]
    return lv.mean(dim=1)


# ---------------------------------------------------------------------------
# computation graph (bottom-level IR)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MLNode:
    id: int
    atom: Atom
    args: Tuple[Ref, ...]


@dataclasses.dataclass
class MLGraph:
    nodes: List[MLNode]  # topologically ordered
    out: int             # output node id
    n_inputs: int

    def node(self, nid: int) -> MLNode:
        for n in self.nodes:
            if n.id == nid:
                return n
        raise KeyError(nid)

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        vals: Dict[int, torch.Tensor] = {}
        for n in self.nodes:
            xs = [inputs[r[1]] if r[0] == "in" else vals[r[1]] for r in n.args]
            vals[n.id] = n.atom.apply(*xs)
        return vals[self.out]

    def infer_dims(self, in_dims: Sequence[int]) -> Dict[int, int]:
        dims: Dict[int, int] = {}
        for n in self.nodes:
            arg_dims = [in_dims[r[1]] if r[0] == "in" else dims[r[1]] for r in n.args]
            dims[n.id] = n.atom.out_dim(arg_dims)
        return dims

    def out_dim(self, in_dims: Sequence[int]) -> int:
        return self.infer_dims(in_dims)[self.out]

    def flops_per_row(self, in_dims: Sequence[int]) -> float:
        dims = self.infer_dims(in_dims)
        total = 0.0
        for n in self.nodes:
            arg_dims = [in_dims[r[1]] if r[0] == "in" else dims[r[1]] for r in n.args]
            total += n.atom.flops_per_row(arg_dims)
        return total

    def param_bytes(self) -> int:
        return sum(n.atom.param_bytes() for n in self.nodes)

    def input_deps(self) -> Dict[int, frozenset]:
        """node id -> set of graph-input indices it (transitively) depends on."""
        deps: Dict[int, frozenset] = {}
        for n in self.nodes:
            s = set()
            for r in n.args:
                if r[0] == "in":
                    s.add(r[1])
                else:
                    s |= deps[r[1]]
            deps[n.id] = frozenset(s)
        return deps

    def fresh_id(self) -> int:
        return max((n.id for n in self.nodes), default=-1) + 1


def chain(atoms: Sequence[Atom], n_inputs: int = 1) -> MLGraph:
    """Sequential graph: in0 -> a0 -> a1 -> ... (single input)."""
    nodes: List[MLNode] = []
    prev: Ref = ("in", 0)
    for i, a in enumerate(atoms):
        nodes.append(MLNode(id=i, atom=a, args=(prev,)))
        prev = ("node", i)
    return MLGraph(nodes=nodes, out=len(atoms) - 1, n_inputs=n_inputs)


# ---------------------------------------------------------------------------
# high-level ML function
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MLFunction:
    """A registered (possibly analyzable) ML function.

    ``graph`` is the bottom-level IR; ``opaque_fn`` is used instead when the
    model is a true black box.
    """

    name: str
    graph: Optional[MLGraph] = None
    opaque_fn: Optional[Callable[..., torch.Tensor]] = None
    n_inputs: int = 1
    # optional hint for selectivity when used as a boolean filter
    selectivity_hint: Optional[float] = None
    # a black box's FLOPs per row, where its owner knows them (the oracle
    # otherwise prices it at a constant 1e6, which makes an LLM look free)
    flops_hint: Optional[float] = None

    def apply(self, *inputs: torch.Tensor) -> torch.Tensor:
        if self.graph is not None:
            return self.graph.apply(*inputs)
        assert self.opaque_fn is not None, f"{self.name} has no implementation"
        return self.opaque_fn(*inputs)

    def flops_per_row(self, in_dims: Sequence[int]) -> float:
        if self.graph is not None:
            return self.graph.flops_per_row(in_dims)
        if self.flops_hint is not None:
            return self.flops_hint
        return 1e6  # unknown black box: pessimistic constant

    def out_dim(self, in_dims: Sequence[int]) -> int:
        if self.graph is not None:
            return self.graph.out_dim(in_dims)
        return 0

    def param_bytes(self) -> int:
        return self.graph.param_bytes() if self.graph is not None else 0
