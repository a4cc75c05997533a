"""ML functions: the bottom-level IR vocabulary (paper Sec. III-B).

Atomic ML functions (``Atom``) are batch-apply primitives with shape/FLOPs
introspection. High-level ML functions are ``MLGraph`` compositions of atoms,
registered in a ``Registry`` at model-loading time (paper Fig. 3, steps 1-2).
"""
from repro_torch.mlfuncs.functions import Atom, MLGraph, MLNode, MLFunction
from repro_torch.mlfuncs.registry import Registry
from repro_torch.mlfuncs import builders

__all__ = ["Atom", "MLGraph", "MLNode", "MLFunction", "Registry", "builders"]
