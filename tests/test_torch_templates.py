"""The port's query templates and numpy oracle against the JAX package's.

``templates.sample_query(t, seed, scale)`` builds, for each of the 20
templates, the JAX package's catalog (int columns exact, floats equal) and
plan (same signature); each query's result on the CPU equals the JAX
package's at the ``.canonical()`` bar. ``ood_split`` is the same. The
numpy oracle's operators give the JAX package's outputs on seeded tables.
"""
import numpy as np
import pytest

from repro.core import executor as jex
from repro.data import templates as jtemplates
from repro.relational import oracle as joracle
from repro_torch.core import executor
from repro_torch.data import templates
from repro_torch.relational import oracle
from repro_torch.testing import assert_canonical_close

SCALE = 0.3


@pytest.mark.parametrize("t", sorted(jtemplates.TEMPLATES))
def test_sample_query_matches_jax(t):
    jplan, jcat = jtemplates.sample_query(t, seed=50 + t, scale=SCALE)
    tplan, tcat = templates.sample_query(t, seed=50 + t, scale=SCALE, device="cpu")
    assert tplan.signature() == jplan.signature()
    assert set(tcat.np_tables) == set(jcat.np_tables)
    for name, cols in jcat.np_tables.items():
        assert set(tcat.np_tables[name]) == set(cols)
        for c, a in cols.items():
            np.testing.assert_array_equal(tcat.np_tables[name][c], a, err_msg=f"{name}.{c}")
        assert tcat.stats[name].capacity == jcat.stats[name].capacity
    out = executor.execute(tplan, tcat, device="cpu").canonical()
    assert_canonical_close(jex.execute(jplan, jcat).canonical(), out, f"template {t}")
    for k, v in out.items():
        assert np.isfinite(np.asarray(v, np.float64)).all(), (t, k)


def test_catalogs_are_shared_per_family_scale_and_device():
    a = templates.catalog("ml", SCALE, "cpu")
    assert templates.catalog("ml", SCALE, "cpu") is a
    assert templates.catalog("tp", SCALE, "cpu") is not a
    assert templates.sample_query(4, seed=1, scale=SCALE, device="cpu")[1] is a


def test_ood_split_matches_jax():
    ind, ood = templates.ood_split()
    assert (ind, ood) == jtemplates.ood_split()
    assert len(ind) == 14 and len(ood) == 6 and not set(ind) & set(ood)
    assert templates.ood_split(7) == jtemplates.ood_split(7)


def _tables(seed):
    rng = np.random.default_rng(seed)
    left = {"id": np.arange(12, dtype=np.int32),
            "k": rng.integers(0, 5, 12).astype(np.int32),
            "x": rng.standard_normal(12).astype(np.float32),
            "v": rng.standard_normal((12, 3)).astype(np.float32)}
    right = {"rk": np.array([4, 0, 2, 3], np.int32),
             "y": rng.standard_normal(4).astype(np.float32),
             "w": rng.standard_normal((4, 2)).astype(np.float32)}
    return left, right


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", range(3))
def test_oracle_matches_jax(seed):
    left, right = _tables(seed)
    mask = left["x"] > 0
    j, t = joracle, oracle
    _equal(j.filter_(left, mask), t.filter_(left, mask))
    new = {"z": left["x"] * 2}
    _equal(j.project(left, new), t.project(left, new))
    _equal(j.project(left, new, keep=("id",)), t.project(left, new, keep=("id",)))
    _equal(j.fk_join(left, right, "k", "rk", "r_"), t.fk_join(left, right, "k", "rk", "r_"))
    _equal(j.fk_join(left, right, "k", "rk"), t.fk_join(left, right, "k", "rk"))
    _equal(j.cross_join(right, right, "a_", "b_"), t.cross_join(right, right, "a_", "b_"))
    aggs = {"n": ("count", "x"), "s": ("sum", "x"), "m": ("mean", "v"),
            "lo": ("min", "x"), "hi": ("max", "v")}
    _equal(j.aggregate(left, "k", aggs), t.aggregate(left, "k", aggs))
    _equal(j.union_all(left, left), t.union_all(left, left))
    _equal(j.canonical(left), t.canonical(left))
    _equal(j.canonical({}), t.canonical({}))
