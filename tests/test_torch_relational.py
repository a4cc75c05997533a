"""PyTorch port's tables and relational operators against the JAX package.

The same numpy inputs, made from a seed, go through ``repro.relational`` and
``repro_torch.relational`` (on the CPU). Valid masks and integer columns
must agree exactly, float columns to 1e-5 (segment sums may add in another
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.relational import ops as jops
from repro.relational.table import Table as JTable
from repro_torch.relational import ops as tops
from repro_torch.relational.table import Table as TTable

FLOAT_TOL = 1e-5


def _tables(cols, valid=None):
    """The same columns as a JAX Table and a port Table on the CPU."""
    jt = JTable.from_columns({k: jnp.asarray(v) for k, v in cols.items()},
                             valid=None if valid is None else jnp.asarray(valid))
    tt = TTable.from_columns(cols, valid=valid, device="cpu")
    return jt, tt


def assert_same(jt: JTable, tt: TTable, full: bool = False):
    """Masks exact; valid rows (or, with ``full``, all rows) equal."""
    np.testing.assert_array_equal(np.asarray(jt.valid), tt.valid.numpy())
    assert set(jt.columns) == set(tt.columns)
    for k in jt.columns:
        a = np.asarray(jt.columns[k])
        b = tt.columns[k].numpy()
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if not full:
            a, b = a[np.asarray(jt.valid)], b[tt.valid.numpy()]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=FLOAT_TOL, atol=FLOAT_TOL, err_msg=k)


def _fact(rng, n, n_keys, valid_frac=0.8):
    cols = {
        "k": rng.integers(0, n_keys, n).astype(np.int32),
        "x": rng.standard_normal(n).astype(np.float32),
        "v": rng.standard_normal((n, 3)).astype(np.float32),
    }
    return cols, rng.random(n) < valid_frac


def test_from_columns_keeps_32_bit_types():
    t = TTable.from_columns({"i": np.arange(4), "f": np.ones(4)}, device="cpu")
    assert t["i"].dtype == torch.int32 and t["f"].dtype == torch.float32
    assert t.valid.dtype == torch.bool and t.capacity == 4
    with pytest.raises(ValueError):
        TTable.from_columns({"a": np.arange(3), "b": np.arange(4)}, device="cpu")


def test_table_accessors_and_canonical():
    rng = np.random.default_rng(0)
    cols, valid = _fact(rng, 40, 6)
    jt, tt = _tables(cols, valid)
    assert tt.names == jt.names and int(tt.num_valid()) == int(jt.num_valid())
    assert_same(jt.select(["k", "v"]), tt.select(["k", "v"]))
    assert_same(jt.rename({"x": "y"}), tt.rename({"x": "y"}))
    e = TTable.empty_like(tt, 7)
    assert e.capacity == 7 and not bool(e.valid.any()) and e["v"].shape == (7, 3)
    ca, cb = jt.canonical(), tt.canonical()
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)


def test_filter_and_project():
    rng = np.random.default_rng(1)
    cols, valid = _fact(rng, 50, 5)
    jt, tt = _tables(cols, valid)
    mask = cols["x"] > 0
    assert_same(jops.filter_(jt, jnp.asarray(mask)), tops.filter_(tt, torch.as_tensor(mask)))
    new = (2 * cols["x"]).astype(np.float32)
    assert_same(jops.project(jt, {"y": jnp.asarray(new)}, keep=["k"]),
                tops.project(tt, {"y": torch.as_tensor(new)}, keep=["k"]))


@pytest.mark.parametrize("capacity", [0, 9, 30, 64, 80])
def test_compact_is_stable(capacity):
    """Valid rows move to the front in input order (stable sort over the
    many tied sort keys); beyond the input capacity rows stay invalid."""
    rng = np.random.default_rng(2)
    cols, valid = _fact(rng, 64, 7, valid_frac=0.4)
    jt, tt = _tables(cols, valid)
    assert_same(jops.compact(jt, capacity), tops.compact(tt, capacity), full=True)


@pytest.mark.parametrize("seed", [3, 4])
def test_fk_join_invalid_and_out_of_range_keys(seed):
    rng = np.random.default_rng(seed)
    n_dim = 20
    right = {"id": rng.permutation(n_dim).astype(np.int32),
             "payload": rng.standard_normal((n_dim, 4)).astype(np.float32),
             "w": rng.standard_normal(n_dim).astype(np.float32)}
    right_valid = rng.random(n_dim) < 0.7  # invalid dimension rows
    left = {"fk": rng.integers(-5, n_dim + 5, 60).astype(np.int32),  # out of range
            "z": rng.standard_normal(60).astype(np.float32)}
    left["fk"][:3] = np.iinfo(np.int32).max  # the sentinel never matches
    left_valid = rng.random(60) < 0.9
    jl, tl = _tables(left, left_valid)
    jr, tr = _tables(right, right_valid)
    assert_same(jops.fk_join(jl, jr, "fk", "id", rprefix="r_"),
                tops.fk_join(tl, tr, "fk", "id", rprefix="r_"))
    # join key of the same name is kept once (left copy)
    jr2, tr2 = jr.rename({"id": "fk"}), tr.rename({"id": "fk"})
    assert_same(jops.fk_join(jl, jr2, "fk", "fk"), tops.fk_join(tl, tr2, "fk", "fk"))


def test_cross_join():
    rng = np.random.default_rng(5)
    a, av = _fact(rng, 7, 3)
    b = {"m": np.arange(5, dtype=np.int32),
         "e": rng.standard_normal((5, 2)).astype(np.float32)}
    bv = np.array([True, False, True, True, False])
    ja, ta = _tables(a, av)
    jb, tb = _tables(b, bv)
    assert_same(jops.cross_join(ja, jb, "a_", "b_"), tops.cross_join(ta, tb, "a_", "b_"),
                full=True)


@pytest.mark.parametrize("num_groups,n_keys", [(4, 9), (9, 9), (40, 9), (200, 30)])
def test_aggregate_all_kinds(num_groups, n_keys):
    """sum/mean/count/min/max over scalar and vector columns, tied keys,
    group bounds below, at and above the distinct-key count, and (200) a
    bound larger than the row count."""
    rng = np.random.default_rng(6)
    cols, valid = _fact(rng, 120, n_keys)
    cols["k"] = (cols["k"] * 7 - 3).astype(np.int32)  # sparse, negative keys
    jt, tt = _tables(cols, valid)
    aggs = {"s": ("sum", "x"), "m": ("mean", "x"), "c": ("count", "x"),
            "lo": ("min", "x"), "hi": ("max", "x"), "vs": ("sum", "v"),
            "vm": ("mean", "v"), "vlo": ("min", "v"), "vhi": ("max", "v")}
    assert_same(jops.aggregate(jt, "k", aggs, num_groups),
                tops.aggregate(tt, "k", aggs, num_groups), full=True)


def test_aggregate_unknown_kind_raises():
    _, tt = _tables({"k": np.zeros(3, np.int32), "x": np.ones(3, np.float32)})
    with pytest.raises(ValueError):
        tops.aggregate(tt, "k", {"o": ("median", "x")}, 2)


def test_union_all():
    rng = np.random.default_rng(7)
    a, av = _fact(rng, 10, 3)
    b, bv = _fact(rng, 6, 3)
    ja, ta = _tables(a, av)
    jb, tb = _tables(b, bv)
    assert_same(jops.union_all(ja, jb), tops.union_all(ta, tb), full=True)
    with pytest.raises(ValueError):
        tops.union_all(ta, tb.select(["k"]))
