"""PyTorch port's ML functions and kernels against the JAX package.

Atoms: all 19 kinds against ``repro.mlfuncs.functions.Atom.apply`` on the
same numpy inputs. Builders: equal seeds give bit-identical weights. Kernels:
the port's wrappers run their plain versions on CPU tensors and are held
against ``repro.kernels.*.ops`` in Pallas interpret mode, at the shapes and
bars of ``tests/test_kernels.py`` (1e-4 in float32, 3e-2 in bfloat16). The
CUDA kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_matmul import ops as j_bm
from repro.kernels.decision_forest import ops as j_df
from repro.kernels.fused_dense import ops as j_fd
from repro.mlfuncs import builders as jb
from repro.mlfuncs.functions import Atom as JAtom
from repro_torch.kernels.block_matmul import ops as t_bm, ref as t_bm_ref
from repro_torch.kernels.decision_forest import ops as t_df, ref as t_df_ref
from repro_torch.kernels.fused_dense import ops as t_fd, ref as t_fd_ref
from repro_torch.mlfuncs import builders as tb
from repro_torch.mlfuncs.functions import Atom as TAtom

ATOM_TOL = 1e-5
F32_TOL, BF16_TOL = 1e-4, 3e-2
ACTS = t_fd_ref.ACTS  # the activations the fused_dense kernel has


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               torch.as_tensor(b).float().numpy(), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# atoms
# ---------------------------------------------------------------------------

def _forest_params(rng, n_trees, depth, d):
    nn = 2 ** depth - 1
    return {"feat": rng.integers(0, d, (n_trees, nn)).astype(np.int32),
            "thresh": _f32(rng, (n_trees, nn)),
            "leaf": _f32(rng, (n_trees, 2 ** depth)), "depth": depth}


def _atom_cases():
    """(case id, kind, params, input arrays) for every atom kind."""
    rng = _rng(0)
    n = 13
    x8, y8 = _f32(rng, (n, 8)), _f32(rng, (n, 8))
    ids = rng.integers(-3, 12, n).astype(np.float32)  # some out of range
    cases = [
        ("matmul", "matmul", {"w": _f32(rng, (8, 5))}, [x8]),
        ("matmul_scalar_in", "matmul", {"w": _f32(rng, (1, 4))}, [x8[:, 0]]),
        ("bias", "bias", {"b": _f32(rng, (8,))}, [x8]),
        ("concat", "concat", {}, [x8, y8[:, 0], ids]),
        ("cossim", "cossim", {}, [x8, y8]),
        ("dot", "dot", {}, [x8, y8]),
        ("dist", "dist", {}, [x8, y8]),
        ("embed_out_of_range", "embed", {"table": _f32(rng, (10, 6))}, [ids]),
        ("scale", "scale", {"mean": _f32(rng, (8,)),
                            "std": np.abs(_f32(rng, (8,)))}, [x8]),
        ("onehot_out_of_range", "onehot", {"num": 9}, [ids]),
        ("binarize", "binarize", {"threshold": 0.25}, [x8[:, 0]]),
        ("forest", "forest", _forest_params(rng, 6, 4, 8), [x8]),
        ("slice", "slice", {"start": 2, "stop": 6}, [x8]),
        ("add", "add", {}, [x8, y8]),
        ("mul", "mul", {}, [x8, y8]),
        ("sqrt", "sqrt", {}, [x8]),
        ("argmin", "argmin", {}, [x8]),
        ("const_vec", "const_vec", {"value": _f32(rng, (3,))}, [x8]),
    ]
    for fn in ACTS + ("softmax",):
        cases.append((f"act_{fn}", "act", {"fn": fn}, [x8 * 3]))
    for act in ACTS + ("softmax",):
        cases.append((f"fused_dense_{act}", "fused_dense",
                      {"w": _f32(rng, (8, 6)), "b": _f32(rng, (6,)), "act": act}, [x8]))
    return cases


ATOM_CASES = _atom_cases()


def test_atom_cases_cover_all_kinds():
    assert len({kind for _, kind, _, _ in ATOM_CASES}) == 19


@pytest.mark.parametrize("case", ATOM_CASES, ids=[c[0] for c in ATOM_CASES])
def test_atom_matches_jax(case):
    _, kind, params, xs = case
    ja, ta = JAtom(kind, dict(params)), TAtom(kind, dict(params))
    want = ja.apply(*[jnp.asarray(x) for x in xs])
    got = ta.apply(*[torch.as_tensor(x) for x in xs])
    assert tuple(got.shape) == tuple(want.shape)
    _close(want, got, ATOM_TOL)
    in_dims = [x.shape[1] if x.ndim == 2 else 0 for x in xs]
    assert ta.out_dim(in_dims) == ja.out_dim(in_dims)
    assert ta.flops_per_row(in_dims) == ja.flops_per_row(in_dims)
    assert ta.param_bytes() == ja.param_bytes()


def test_atom_moves_params_once_per_device():
    w = _f32(_rng(1), (4, 3))
    a = TAtom("matmul", {"w": w})
    x = torch.ones((2, 4))
    a.apply(x)
    cached = a.param("w", x.device)
    a.apply(x)
    assert a.param("w", x.device) is cached
    assert isinstance(a.params["w"], np.ndarray)  # the IR keeps numpy
    assert dataclasses.replace(a, backend="kernel")._on_device == {}


# ---------------------------------------------------------------------------
# builders: equal seeds, bit-identical weights
# ---------------------------------------------------------------------------

BUILDER_CALLS = [
    ("ffnn", ("f", [12, 30, 7, 1]), {"seed": 3}),
    ("two_tower", ("t", [16, 40, 8], [10, 40, 8]), {"seed": 4}),
    ("concat_ffnn", ("c", [5, 7], [16, 1]), {"seed": 5}),
    ("autoencoder_encoder", ("a", 64, 32, 8), {"seed": 6}),
    ("logreg", ("l", 9), {"seed": 7}),
    ("decision_forest", ("d", 5, 4, 11), {"seed": 8}),
    ("svd_score", ("s", 20, 15, 4), {"seed": 9}),
    ("embedding", ("e", 30, 6), {"seed": 10}),
    ("dlrm", ("r", 8, 6, [10]), {"seed": 11}),
] + [("sample_model", (seed,), {}) for seed in range(7)]


def _same_graph(jf, tf):
    assert jf.name == tf.name and jf.n_inputs == tf.n_inputs
    assert len(jf.graph.nodes) == len(tf.graph.nodes) and jf.graph.out == tf.graph.out
    for jn, tn in zip(jf.graph.nodes, tf.graph.nodes):
        assert (jn.id, jn.args, jn.atom.kind) == (tn.id, tn.args, tn.atom.kind)
        assert set(jn.atom.params) == set(tn.atom.params)
        for k, v in jn.atom.params.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == tn.atom.params[k].dtype
                np.testing.assert_array_equal(v, tn.atom.params[k])
            else:
                assert v == tn.atom.params[k]


@pytest.mark.parametrize("call", BUILDER_CALLS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(BUILDER_CALLS)])
def test_builders_bit_identical(call):
    name, args, kw = call
    _same_graph(getattr(jb, name)(*args, **kw), getattr(tb, name)(*args, **kw))


def test_kmeans_assign_matches_jax():
    jf, tf = jb.kmeans_assign("k", 5, 6, seed=2), tb.kmeans_assign("k", 5, 6, seed=2)
    np.testing.assert_array_equal(jf.centroids, tf.centroids)
    x = _f32(_rng(3), (17, 6))
    np.testing.assert_array_equal(np.asarray(jf.apply(jnp.asarray(x))),
                                  tf.apply(torch.as_tensor(x)).numpy())


# ---------------------------------------------------------------------------
# kernels: wrappers (plain versions on the CPU) against the Pallas kernels
# ---------------------------------------------------------------------------

# the JAX package's kernel-test shapes, then ragged ones whose rows are not
# 16-byte aligned (the CUDA kernels' element-copy instance on the card)
@pytest.mark.parametrize("m,k,n", [(7, 12, 5), (130, 200, 70), (256, 512, 128),
                                   (1, 128, 128), (5, 13, 7), (33, 300, 70)])
@pytest.mark.parametrize("act", ACTS)
def test_fused_dense_matches_pallas(m, k, n, act):
    rng = _rng(m + k + n)
    x, w, b = _f32(rng, (m, k)), _f32(rng, (k, n)), _f32(rng, (n,))
    want = j_fd.fused_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act)
    args = [torch.as_tensor(a) for a in (x, w, b)]
    _close(want, t_fd.fused_dense(*args, act), F32_TOL)
    _close(want, t_fd_ref.fused_dense(*args, act), F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dense_dtypes(dtype):
    rng = _rng(20)
    x, w, b = _f32(rng, (64, 96)), _f32(rng, (96, 32)), _f32(rng, (32,))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_fd.fused_dense(*(jnp.asarray(a, jd) for a in (x, w, b)), "relu")
    got = t_fd.fused_dense(*(torch.as_tensor(a).to(td) for a in (x, w, b)), "relu")
    assert got.dtype == td
    _close(want, got, F32_TOL if dtype == "float32" else BF16_TOL)


def test_fused_dense_refuses_unknown_activations():
    x, w, b = torch.ones((2, 3)), torch.ones((3, 4)), torch.ones((4,))
    with pytest.raises(ValueError):
        t_fd.fused_dense(x, w, b, "softmax")
    with pytest.raises(ValueError):
        t_fd_ref.fused_dense(x, w, b, "softmax")
    with pytest.raises(ValueError):
        t_fd.fused_dense(x, w, torch.ones((5,)), "relu")
    with pytest.raises(TypeError):
        t_fd.fused_dense(x.double(), w.double(), b.double(), "relu")


@pytest.mark.parametrize("m,k,n,t", [(10, 16, 40, 4), (130, 300, 520, 8),
                                     (64, 512, 1024, 16), (33, 300, 70, 3),
                                     (5, 13, 7, 1), (7, 12, 5, 2)])
def test_block_matmul_matches_pallas(m, k, n, t):
    rng = _rng(m + n)
    x, w = _f32(rng, (m, k)), _f32(rng, (k, n))
    want = j_bm.block_matmul(jnp.asarray(x), jnp.asarray(w), t)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    _close(want, t_bm.block_matmul(xt, wt, t), F32_TOL)
    _close(want, t_bm_ref.block_matmul(xt, wt, t), F32_TOL)


def test_block_matmul_checks_operands():
    with pytest.raises(ValueError):
        t_bm.block_matmul(torch.ones((2, 3)), torch.ones((4, 5)))
    with pytest.raises(TypeError):
        t_bm.block_matmul(torch.ones((2, 3)), torch.ones((3, 5), dtype=torch.bfloat16))


# the JAX package's kernel-test shapes, then the forests of retail_q2,
# simple_q2, analytics_q1, analytics_q2 and analytics_q3 at a few rows
@pytest.mark.parametrize("n,d,t,depth", [(20, 8, 4, 3), (150, 16, 10, 5),
                                         (64, 29, 25, 6), (50, 32, 160, 6),
                                         (45, 40, 50, 6), (40, 29, 100, 9),
                                         (33, 96, 1, 9), (20, 128, 100, 9)])
def test_decision_forest_matches_pallas(n, d, t, depth):
    rng = _rng(n + d)
    p = _forest_params(rng, t, depth, d)
    x = _f32(rng, (n, d))
    want = j_df.forest_predict(*(jnp.asarray(a) for a in (x, p["feat"], p["thresh"], p["leaf"])))
    args = [torch.as_tensor(a) for a in (x, p["feat"], p["thresh"], p["leaf"])]
    _close(want, t_df.forest_predict(*args), F32_TOL)
    _close(want, t_df_ref.forest_predict(*args), F32_TOL)


def test_forest_kernel_backend_matches_atoms():
    """R4-2's swap: the forest atom on backend 'kernel' == 'torch' == JAX."""
    fn = tb.decision_forest("f", 8, 4, 12, seed=3)
    atom = fn.graph.nodes[0].atom
    x = _f32(_rng(4), (40, 12))
    want = jb.decision_forest("f", 8, 4, 12, seed=3).graph.nodes[0].atom.apply(jnp.asarray(x))
    _close(want, atom.apply(torch.as_tensor(x)), F32_TOL)
    _close(want, dataclasses.replace(atom, backend="kernel").apply(torch.as_tensor(x)), F32_TOL)


def test_fused_dense_atom_backend_swap():
    rng = _rng(5)
    w, b, x = _f32(rng, (24, 48)), _f32(rng, (48,)), _f32(rng, (20, 24))
    a = TAtom("fused_dense", {"w": w, "b": b, "act": "relu"})
    want = JAtom("fused_dense", {"w": w, "b": b, "act": "relu"}, backend="pallas").apply(
        jnp.asarray(x))
    _close(want, a.apply(torch.as_tensor(x)), F32_TOL)
    _close(want, dataclasses.replace(a, backend="kernel").apply(torch.as_tensor(x)), F32_TOL)
