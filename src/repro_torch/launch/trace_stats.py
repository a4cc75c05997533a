"""Collective bytes and op counts of a traced step: the port's counterpart
of ``repro.launch.hlo_stats``.

The reference sums the result-shape bytes of every all-gather,
all-reduce, reduce-scatter, all-to-all and collective-permute in the
optimized HLO. The port's collectives all go through ``core.mesh``, which
counts the bytes of each one's result by kind and mesh axis as it runs;
``collective_bytes`` folds that counter into the reference's record (bytes
by kind and their ``total``), ``by_axis`` into bytes by mesh axis, which
the dry run's roofline prices by where each axis's groups lie.
``count_ops`` counts an op in a ``trace_cost.TraceCost``'s trace, as the
reference counts an op's occurrences in the HLO text.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Mapping, Tuple


def collective_bytes(counts: Mapping[Tuple[str, str], int]) -> Dict[str, int]:
    """Bytes moved per collective kind, summed over the axes, and their
    ``total`` (``core.mesh.collective_bytes()`` or a trace's
    ``collectives``)."""
    out: Dict[str, int] = defaultdict(int)
    for (kind, _), n in counts.items():
        out[kind] += n
    out["total"] = sum(out.values())
    return dict(out)


def by_axis(counts: Mapping[Tuple[str, str], int]) -> Dict[str, int]:
    """Bytes moved per mesh axis, summed over the kinds."""
    out: Dict[str, int] = defaultdict(int)
    for (_, axis), n in counts.items():
        out[axis] += n
    return dict(out)


def count_ops(trace, opname: str) -> int:
    """How often ``opname`` ran in ``trace`` (a ``TraceCost``, or its
    ``ops`` Counter): a qualified name (``aten.mm``,
    ``repro_torch.flash_attention``) or the bare name, over every
    namespace."""
    ops = getattr(trace, "ops", trace)
    if "." in opname:
        return ops.get(opname, 0)
    return sum(n for name, n in ops.items() if name.rsplit(".", 1)[-1] == opname)
