"""ML function registry (paper Fig. 3 step 2: register computational graphs).

A Registry instance is attached to a query workload; the optimizer resolves
CALLFUNC expression nodes against it to reach the bottom-level IR.
"""
from __future__ import annotations

from typing import Dict, Iterator

from repro_torch.mlfuncs.functions import MLFunction


class Registry:
    def __init__(self) -> None:
        self._fns: Dict[str, MLFunction] = {}

    def register(self, fn: MLFunction) -> MLFunction:
        if fn.name in self._fns:
            raise ValueError(f"duplicate ML function {fn.name}")
        self._fns[fn.name] = fn
        return fn

    def replace(self, fn: MLFunction) -> MLFunction:
        self._fns[fn.name] = fn
        return fn

    def get(self, name: str) -> MLFunction:
        return self._fns[name]

    def __contains__(self, name: str) -> bool:
        return name in self._fns

    def __iter__(self) -> Iterator[str]:
        return iter(self._fns)

    def fresh_name(self, base: str) -> str:
        i = 0
        while f"{base}_{i}" in self._fns:
            i += 1
        return f"{base}_{i}"

    def copy(self) -> "Registry":
        r = Registry()
        r._fns = dict(self._fns)
        return r
