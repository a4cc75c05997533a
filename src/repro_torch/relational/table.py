"""Static-shape columnar Table.

``columns`` maps name -> tensor whose leading axis is the row capacity;
``valid`` is a bool[capacity] mask. Invalid rows carry garbage values and
must never influence query results: every operator and every test is
mask-aware.

Columns may be scalar (shape [N]) or vector (shape [N, d]), the paper's
``V: vec in R^d`` feature-vector columns (Sec. III-A).

Integer columns are int32 and float columns float32, as in the JAX package
with 64-bit mode off: ``from_columns`` narrows int64 and float64 inputs, so
key columns and the int32 sentinel of ``relational.ops`` agree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def as_tensor(v, device) -> torch.Tensor:
    """Array -> tensor on ``device``, int64/float64 narrowed to 32 bits."""
    if not isinstance(v, torch.Tensor):
        v = np.asarray(v)
        if not v.flags.writeable:  # e.g. a view of a JAX array
            v = v.copy()
    t = torch.as_tensor(v, device=device)
    return t.to(_NARROW[t.dtype]) if t.dtype in _NARROW else t


@dataclasses.dataclass
class Table:
    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor  # bool[capacity]

    # -- construction ----------------------------------------------------
    @classmethod
    def from_columns(cls, columns: Mapping[str, object], valid=None,
                     device=None) -> "Table":
        dev = resolve_device(device)
        cols = {k: as_tensor(v, dev) for k, v in columns.items()}
        n = next(iter(cols.values())).shape[0]
        for k, v in cols.items():
            if v.shape[0] != n:
                raise ValueError(f"column {k} has {v.shape[0]} rows, expected {n}")
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=dev)
        return cls(columns=cols, valid=as_tensor(valid, dev).to(torch.bool))

    @classmethod
    def empty_like(cls, other: "Table", capacity: int) -> "Table":
        cols = {
            k: torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=v.device)
            for k, v in other.columns.items()
        }
        return cls(columns=cols, valid=torch.zeros((capacity,), dtype=torch.bool,
                                                   device=other.device))

    def to(self, device) -> "Table":
        """The same table on ``device`` (itself if it is there already)."""
        device = torch.device(device)
        if self.valid.device == device:
            return self
        return Table(columns={k: v.to(device) for k, v in self.columns.items()},
                     valid=self.valid.to(device))

    # -- accessors --------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def names(self):
        return tuple(sorted(self.columns))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def with_columns(self, new: Mapping[str, torch.Tensor]) -> "Table":
        cols = dict(self.columns)
        cols.update(new)
        return Table(columns=cols, valid=self.valid)

    def select(self, names) -> "Table":
        return Table(columns={n: self.columns[n] for n in names}, valid=self.valid)

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        cols = {mapping.get(k, k): v for k, v in self.columns.items()}
        return Table(columns=cols, valid=self.valid)

    # -- materialization (host side, for tests / oracles) -----------------
    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Valid rows only, as numpy, in storage order."""
        mask = self.valid.cpu().numpy()
        return {k: v.cpu().numpy()[mask] for k, v in self.columns.items()}

    def canonical(self) -> Dict[str, np.ndarray]:
        """Valid rows sorted by a total order over all scalar columns, used
        to compare plan outputs irrespective of row order."""
        data = self.to_numpy()
        if not data:
            return data
        n = next(iter(data.values())).shape[0]
        if n == 0:
            return data
        keys = []
        for name in sorted(data):
            arr = data[name]
            if arr.ndim == 1:
                keys.append(np.round(arr.astype(np.float64), 4))
            else:
                keys.append(np.round(arr.astype(np.float64).sum(axis=tuple(range(1, arr.ndim))), 4))
        order = np.lexsort(tuple(reversed(keys)))
        return {k: v[order] for k, v in data.items()}
