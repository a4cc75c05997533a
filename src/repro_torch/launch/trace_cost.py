"""FLOPs, bytes and memory of a traced step: the port's counterpart of
``repro.launch.hlo_cost``.

The reference parses the optimized per-device HLO of a jitted step. torch
has no HLO, so this module reads what torch exposes: ``TraceCost``, a
``TorchDispatchMode``, sees every ATen op and custom operator that one
eager run of the step dispatches, on ``meta`` tensors (``launch.dryrun``:
shapes only, nothing allocated) or on real ones. It mirrors
``hlo_cost``'s cost model (``hlo_cost.py:13-16``):

    flops        products by ``torch.utils.flop_counter``'s formulas (its
                 registry: mm, addmm, bmm, baddbmm, convolutions, SDPA),
                 which ``kernels/*/ops.py`` extend to the port's kernel
                 operators; 1 FLOP an element for the elementwise ops that
                 ``hlo_cost._ELEMWISE`` lists, by their ATen names; a
                 reduce at its input's size
    bytes        each op's tensor operands plus its results, views skipped.
                 The eager port runs every op as its own kernel, so every
                 op is a fusion boundary in XLA's terms and the count is
                 larger than ``hlo_cost``'s of XLA's fused HLO
    score_bytes  0: the port's attention kernels keep the scores on chip,
                 so the roofline with flash kernels is the roofline
    peak_bytes   the peak of live bytes the traced ops allocated, above
                 the arguments (storages that existed before the trace):
                 the counterpart of ``memory_analysis``'s
                 ``temp_size_in_bytes``. The step's outputs (AdamW's new
                 params and moments) count, as they are alive at the end
                 beside the arguments that the caller still holds.

A Python loop runs each iteration's ops, so trip counts need no recovery.
Collective bytes come from ``core.mesh``'s counter (``trace_stats``).
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core import mesh as mesh_util
# the kernel operators register their FLOP formulas on import
from repro_torch.kernels.block_matmul import ops as _bm  # noqa: F401
from repro_torch.kernels.decision_forest import ops as _df  # noqa: F401
from repro_torch.kernels.flash_attention import ops as _fa  # noqa: F401
from repro_torch.kernels.flash_decode import ops as _fd  # noqa: F401
from repro_torch.kernels.fused_dense import ops as _fu  # noqa: F401

# hlo_cost._ELEMWISE by ATen name (an in-place variant counts as its op)
ELEMWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "exp", "log",
    "tanh", "rsqrt", "sqrt", "neg", "abs", "sign", "sgn", "floor", "ceil", "round",
    "sigmoid", "cos", "sin", "atan2", "remainder", "fmod", "where", "clamp",
    "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "expm1", "log1p", "erf", "relu", "reciprocal",
    "square",
})
# reduce-like ops, counted at their input's size (hlo_cost's reduce and
# reduce-window; softmax is its reduces)
REDUCE = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "logsumexp", "var", "std", "var_mean", "norm", "linalg_vector_norm", "any", "all",
    "cumsum", "cumprod", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data",
})


def op_name(func) -> str:
    """``namespace.name`` of an op overload, as ``count_ops`` takes it."""
    packet = func._overloadpacket
    return f"{packet._qualified_op_name.replace('::', '.')}"


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Live:
    """Live bytes of the storages that the traced ops allocated. Each is
    watched by a finalizer on its storage, which torch keeps alive while
    any tensor uses it (views and the tensors autograd saves included), so
    the peak is exact at every op."""

    def __init__(self, args) -> None:
        self.skip = {t.untyped_storage()._cdata for t in _tensors(args)}
        self.known: set = set()
        self.bytes = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.skip or key in self.known:
            return
        n = st.nbytes()
        self.known.add(key)
        self.bytes += n
        self.peak = max(self.peak, self.bytes)
        weakref.finalize(st, self._free, key, n).atexit = False

    def _free(self, key: int, n: int) -> None:
        self.known.discard(key)
        self.bytes -= n


class TraceCost(TorchDispatchMode):
    """Counts the ops dispatched inside it (``with TraceCost(args) as c:``).

    ``args``: the step's arguments (a tree of tensors), whose storages the
    peak leaves out. After the block: ``flops``, ``product_flops`` (the
    formulas' share), ``bytes``, ``score_bytes`` (0), ``peak_bytes``,
    ``ops`` (a Counter of op names, ``op_name``) and ``collectives``
    (``core.mesh``'s bytes by (kind, axis) counted inside the block)."""

    def __init__(self, args=()) -> None:
        super().__init__()
        self.live = _Live(args)
        self.flops = 0
        self.product_flops = 0
        self.bytes = 0
        self.score_bytes = 0
        self.ops: collections.Counter = collections.Counter()
        self.collectives: Dict[tuple, int] = {}
        self._depth = 0

    @property
    def peak_bytes(self) -> int:
        return self.live.peak

    def __enter__(self):
        # the mode re-enters itself to decompose an op: count from the
        # outermost entry to the outermost exit
        self._depth += 1
        if self._depth == 1:
            mesh_util.reset_collective_bytes()
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            self.collectives = mesh_util.collective_bytes()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry:
            # a composite op counts as the ops it decomposes into, as
            # FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = packet.__name__
        self.ops[op_name(func)] += 1
        outs = _tensors(out)
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.product_flops += n
        elif name.rstrip("_") in ELEMWISE:
            self.flops += sum(t.numel() for t in outs)
        elif name.rstrip("_") in REDUCE:
            self.flops += sum(t.numel() for t in _tensors((args, kwargs)))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
            for t in outs:
                if t.layout == torch.strided:
                    self.live.add(t)
        return out


def analyze(fn, *args, **kwargs) -> Dict:
    """``fn(*args, **kwargs)`` run once under ``TraceCost``: the
    reference's ``hlo_cost.analyze`` record (``flops``, ``bytes``,
    ``collectives`` by kind with ``total``, ``score_bytes``,
    ``unknown_loops`` 0) and ``product_flops``, ``peak_bytes`` and the
    result ``out``."""
    from repro_torch.launch import trace_stats
    with TraceCost((args, kwargs)) as cost:
        out = fn(*args, **kwargs)
    return {"flops": cost.flops, "product_flops": cost.product_flops, "bytes": cost.bytes,
            "collectives": trace_stats.collective_bytes(cost.collectives),
            "score_bytes": cost.score_bytes, "unknown_loops": 0,
            "peak_bytes": cost.peak_bytes, "ops": cost.ops, "out": out}
