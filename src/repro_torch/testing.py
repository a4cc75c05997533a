"""Comparison helpers shared by the parity tests and ``chip_smoke.py``."""
from __future__ import annotations

from typing import Mapping

import numpy as np

WORKLOAD_TOL = 5e-4  # .canonical() bar of the JAX package's workload tests


def assert_canonical_close(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray],
                           label: str = "", tol: float = WORKLOAD_TOL) -> None:
    """Two ``Table.canonical()`` dicts agree: same columns and row count,
    integer and bool columns exactly, float columns at rtol=atol=``tol``."""
    if set(a) != set(b):
        raise AssertionError(f"{label}: schemas differ {sorted(set(a) ^ set(b))}")
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape:
            raise AssertionError(f"{label}:{k}: shapes {x.shape} vs {y.shape}")
        if x.dtype.kind in "biu" and y.dtype.kind in "biu":
            np.testing.assert_array_equal(x, y, err_msg=f"{label}:{k}")
        else:
            np.testing.assert_allclose(x, y, rtol=tol, atol=tol, err_msg=f"{label}:{k}")
