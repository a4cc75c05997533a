"""High-level ML function builders + the Appendix-M model sampler.

Each builder returns an ``MLFunction`` whose ``graph`` is the bottom-level IR
(matMul/bias/act/embed/... atoms). The sampler draws random architectures
from the paper's templates (MLP, TwoTower, DLRM, CNN-as-MLP, DecisionForest,
AutoEncoder, SVD) to generate Model2Vec training data.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.mlfuncs.functions import Atom, MLGraph, MLNode, MLFunction


def _rng(seed):
    return np.random.default_rng(seed)


def _dense_atoms(rng, dims: Sequence[int], acts: Sequence[str]) -> List[Atom]:
    atoms: List[Atom] = []
    for i in range(len(dims) - 1):
        w = (rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32)
        b = np.zeros((dims[i + 1],), np.float32)
        atoms.append(Atom("matmul", {"w": w}))
        atoms.append(Atom("bias", {"b": b}))
        atoms.append(Atom("act", {"fn": acts[i]}))
    return atoms


def ffnn(name: str, dims: Sequence[int], acts: Sequence[str] | None = None,
         seed: int = 0) -> MLFunction:
    """Fully connected network: matmul->bias->act per layer."""
    rng = _rng(seed)
    if acts is None:
        acts = ["relu"] * (len(dims) - 2) + ["sigmoid"]
    atoms = _dense_atoms(rng, dims, acts)
    nodes, prev = [], ("in", 0)
    for i, a in enumerate(atoms):
        nodes.append(MLNode(id=i, atom=a, args=(prev,)))
        prev = ("node", i)
    g = MLGraph(nodes=nodes, out=len(atoms) - 1, n_inputs=1)
    return MLFunction(name=name, graph=g, n_inputs=1)


def _tower_nodes(rng, nodes: List[MLNode], start_id: int, in_ref, dims, acts):
    prev = in_ref
    nid = start_id
    for i in range(len(dims) - 1):
        w = (rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32)
        b = np.zeros((dims[i + 1],), np.float32)
        for atom in (Atom("matmul", {"w": w}), Atom("bias", {"b": b}),
                     Atom("act", {"fn": acts[i]})):
            nodes.append(MLNode(id=nid, atom=atom, args=(prev,)))
            prev = ("node", nid)
            nid += 1
    return prev, nid


def two_tower(name: str, user_dims: Sequence[int], item_dims: Sequence[int],
              seed: int = 0) -> MLFunction:
    """cosSim(userTower(in0), itemTower(in1)) — the paper's running example."""
    rng = _rng(seed)
    assert user_dims[-1] == item_dims[-1], "tower output dims must match"
    nodes: List[MLNode] = []
    acts_u = ["relu"] * (len(user_dims) - 2) + ["identity"]
    acts_i = ["relu"] * (len(item_dims) - 2) + ["identity"]
    u_ref, nid = _tower_nodes(rng, nodes, 0, ("in", 0), user_dims, acts_u)
    i_ref, nid = _tower_nodes(rng, nodes, nid, ("in", 1), item_dims, acts_i)
    nodes.append(MLNode(id=nid, atom=Atom("cossim"), args=(u_ref, i_ref)))
    g = MLGraph(nodes=nodes, out=nid, n_inputs=2)
    return MLFunction(name=name, graph=g, n_inputs=2)


def concat_ffnn(name: str, in_dims: Sequence[int], hidden: Sequence[int],
                out_act: str = "sigmoid", seed: int = 0) -> MLFunction:
    """f(concat(in0, in1, ...)) with an FFNN f — R2-1's factorizable shape."""
    rng = _rng(seed)
    nodes: List[MLNode] = []
    nodes.append(MLNode(id=0, atom=Atom("concat"),
                        args=tuple(("in", k) for k in range(len(in_dims)))))
    dims = [int(sum(in_dims))] + list(hidden)
    acts = ["relu"] * (len(dims) - 2) + [out_act]
    prev, nid = _tower_nodes(rng, nodes, 1, ("node", 0), dims, acts)
    g = MLGraph(nodes=nodes, out=nid - 1, n_inputs=len(in_dims))
    return MLFunction(name=name, graph=g, n_inputs=len(in_dims))


def autoencoder_encoder(name: str, in_dim: int, hidden: int, code: int,
                        seed: int = 0) -> MLFunction:
    """Encoder half of an autoencoder (paper Q2/Q3: dense representation)."""
    return ffnn(name, [in_dim, hidden, code], acts=["relu", "identity"], seed=seed)


def logreg(name: str, in_dim: int, seed: int = 0) -> MLFunction:
    return ffnn(name, [in_dim, 1], acts=["sigmoid"], seed=seed)


def decision_forest(name: str, n_trees: int, depth: int, n_features: int,
                    seed: int = 0) -> MLFunction:
    rng = _rng(seed)
    n_internal = 2 ** depth - 1
    feat = rng.integers(0, n_features, size=(n_trees, n_internal)).astype(np.int32)
    thresh = rng.standard_normal((n_trees, n_internal)).astype(np.float32)
    leaf = rng.standard_normal((n_trees, 2 ** depth)).astype(np.float32)
    atom = Atom("forest", {"feat": feat, "thresh": thresh, "leaf": leaf, "depth": depth})
    g = MLGraph(nodes=[MLNode(id=0, atom=atom, args=(("in", 0),))], out=0, n_inputs=1)
    return MLFunction(name=name, graph=g, n_inputs=1)


def svd_score(name: str, n_users: int, n_items: int, rank: int, seed: int = 0) -> MLFunction:
    """SVD-style score: dot(U[uid], V[mid]) over (uid, mid) id columns."""
    rng = _rng(seed)
    u = (rng.standard_normal((n_users, rank)) / np.sqrt(rank)).astype(np.float32)
    v = (rng.standard_normal((n_items, rank)) / np.sqrt(rank)).astype(np.float32)
    nodes = [
        MLNode(id=0, atom=Atom("embed", {"table": u}), args=(("in", 0),)),
        MLNode(id=1, atom=Atom("embed", {"table": v}), args=(("in", 1),)),
        MLNode(id=2, atom=Atom("dot"), args=(("node", 0), ("node", 1))),
    ]
    g = MLGraph(nodes=nodes, out=2, n_inputs=2)
    return MLFunction(name=name, graph=g, n_inputs=2)


def embedding(name: str, vocab: int, dim: int, seed: int = 0) -> MLFunction:
    rng = _rng(seed)
    table = (rng.standard_normal((vocab, dim)) / np.sqrt(dim)).astype(np.float32)
    g = MLGraph(nodes=[MLNode(id=0, atom=Atom("embed", {"table": table}),
                              args=(("in", 0),))], out=0, n_inputs=1)
    return MLFunction(name=name, graph=g, n_inputs=1)


def dlrm(name: str, dense_dim: int, emb_dim: int, top_hidden: Sequence[int],
         seed: int = 0) -> MLFunction:
    """Simplified DLRM: top_mlp(concat(bottom_mlp(dense), emb_u, emb_m)).

    Inputs: in0 dense features [N, dense_dim], in1 user emb [N, emb_dim],
    in2 item emb [N, emb_dim] (embeddings precomputed by embed atoms upstream
    or passed as feature columns).
    """
    rng = _rng(seed)
    nodes: List[MLNode] = []
    bot_ref, nid = _tower_nodes(rng, nodes, 0, ("in", 0),
                                [dense_dim, emb_dim], ["relu"])
    nodes.append(MLNode(id=nid, atom=Atom("concat"),
                        args=(bot_ref, ("in", 1), ("in", 2))))
    cat = ("node", nid)
    nid += 1
    dims = [emb_dim * 3] + list(top_hidden) + [1]
    acts = ["relu"] * (len(dims) - 2) + ["sigmoid"]
    out_ref, nid = _tower_nodes(rng, nodes, nid, cat, dims, acts)
    g = MLGraph(nodes=nodes, out=nid - 1, n_inputs=3)
    return MLFunction(name=name, graph=g, n_inputs=3)


def kmeans_assign(name: str, k: int, dim: int, seed: int = 0) -> MLFunction:
    """Distance to nearest centroid (R3-3's target computation)."""
    rng = _rng(seed)
    cents = rng.standard_normal((k, dim)).astype(np.float32)

    on_device = {}  # device -> centroid tensor

    def fn(x):
        c = on_device.get(str(x.device))
        if c is None:
            c = on_device[str(x.device)] = torch.as_tensor(cents, device=x.device)
        d = torch.sum(torch.square(x[:, None, :] - c[None, :, :]), dim=-1)
        return torch.argmin(d, dim=-1).to(torch.float32)

    # graph form: dist to each centroid via matmul trick is possible, but we
    # keep a compact opaque form + a hint; R3-3 uses the centroid table size.
    f = MLFunction(name=name, graph=None, opaque_fn=fn, n_inputs=1)
    f.centroids = cents  # type: ignore[attr-defined]
    return f


# ---------------------------------------------------------------------------
# Appendix-M random model sampler (Model2Vec training data)
# ---------------------------------------------------------------------------

TEMPLATES = ("mlp", "two_tower", "dlrm", "forest", "autoencoder", "svd", "concat_ffnn")


def sample_model(seed: int, name: str | None = None) -> MLFunction:
    rng = _rng(seed)
    t = TEMPLATES[int(rng.integers(0, len(TEMPLATES)))]
    name = name or f"sampled_{t}_{seed}"
    if t == "mlp":
        depth = int(rng.integers(1, 5))
        dims = [int(rng.integers(8, 512))] + [int(rng.integers(16, 1024)) for _ in range(depth)] + [1]
        return ffnn(name, dims, seed=seed)
    if t == "two_tower":
        code = int(rng.integers(16, 256))
        ud = [int(rng.integers(16, 512)), int(rng.integers(64, 512)), code]
        it = [int(rng.integers(16, 512)), int(rng.integers(64, 512)), code]
        return two_tower(name, ud, it, seed=seed)
    if t == "dlrm":
        return dlrm(name, int(rng.integers(8, 256)), int(rng.integers(16, 128)),
                    [int(rng.integers(32, 256))], seed=seed)
    if t == "forest":
        return decision_forest(name, int(rng.integers(8, 256)), int(rng.integers(3, 9)),
                               int(rng.integers(8, 128)), seed=seed)
    if t == "autoencoder":
        return autoencoder_encoder(name, int(rng.integers(128, 4096)),
                                   int(rng.integers(64, 2048)),
                                   int(rng.integers(16, 256)), seed=seed)
    if t == "svd":
        return svd_score(name, int(rng.integers(100, 5000)), int(rng.integers(100, 5000)),
                         int(rng.integers(8, 128)), seed=seed)
    if t == "concat_ffnn":
        k = int(rng.integers(2, 4))
        in_dims = [int(rng.integers(8, 256)) for _ in range(k)]
        hidden = [int(rng.integers(32, 512)), 1]
        return concat_ffnn(name, in_dims, hidden, seed=seed)
    raise AssertionError(t)
