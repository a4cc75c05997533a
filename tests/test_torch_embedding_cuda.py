"""The learned embedder's captured forwards, on the card.

A captured forward has no CPU mode, so every test here is marked ``cuda``
and skips without a CUDA card. This file imports neither JAX nor
``repro``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_embedding_cuda.py

``embed`` and ``predict_latency`` on the card (one CUDA-graph replay per
miss) equal the eager forward of the same weights on the CPU at
rtol=atol=1e-4 whatever the caller's TF32 setting, capture once per
forward, and never replay stale weights after training.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import optimizer as om
from repro_torch.data import templates

TOL = 1e-4  # the card against the CPU, float32, TF32 off inside the embedder


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: captured forwards have no CPU mode")
    return torch.device("cuda")


def _queries(device, n=6):
    return [templates.sample_query(t, seed=50 + t, scale=0.3, device=device)
            for t in range(1, n + 1)]


def _cpu_twin(emb):
    twin = om.init_embedder(0, device="cpu")
    for dst, src in zip(twin.modules(), emb.modules()):
        dst.load_state_dict({k: v.cpu() for k, v in src.state_dict().items()})
    twin.one_model = emb.one_model
    return twin


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_captured_embed_matches_cpu(cuda_device, tf32):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        emb = om.init_embedder(0)
        twin = _cpu_twin(emb)
        for plan, cat in _queries(cuda_device):
            np.testing.assert_allclose(emb.embed(plan, cat), twin.embed(plan, cat),
                                       rtol=TOL, atol=TOL)
            assert emb.predict_latency(plan, cat) == pytest.approx(
                twin.predict_latency(plan, cat), rel=TOL, abs=TOL)
        assert set(emb._graphs) == {"embed", "latency"}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_one_capture_per_forward(cuda_device):
    emb = om.init_embedder(0)
    queries = _queries(cuda_device)
    emb.embed(*queries[0])
    graph = emb._graphs["embed"]
    for plan, cat in queries[1:]:
        emb.embed(plan, cat)
    assert emb._graphs["embed"] is graph
    assert emb.cache_stats.misses == len(queries) and graph.pool_bytes >= 0


@pytest.mark.cuda
def test_training_replaces_the_captured_forward(cuda_device):
    """After training, embeddings come from the new weights: equal to the
    CPU twin of the trained embedder, not to the old capture's output."""
    emb = om.init_embedder(0)
    queries = _queries(cuda_device)
    plans, cats = zip(*queries)
    before = emb.embed(plans[0], cats[0])
    lat_before = emb.predict_latency(plans[0], cats[0])
    om.train_query2vec(emb, plans, cats, steps=3, batch=2)
    om.train_latency(emb, plans, cats, [1e-3 * (i + 1) for i in range(len(plans))],
                     steps=3, batch=2)
    after = emb.embed(plans[0], cats[0])
    twin = _cpu_twin(emb)
    np.testing.assert_allclose(after, twin.embed(plans[0], cats[0]), rtol=TOL, atol=TOL)
    assert not np.allclose(after, before, rtol=TOL, atol=TOL)
    assert emb.predict_latency(plans[0], cats[0]) == pytest.approx(
        twin.predict_latency(plans[0], cats[0]), rel=TOL, abs=TOL)
    assert emb.predict_latency(plans[0], cats[0]) != lat_before


@pytest.mark.cuda
def test_training_on_the_card_matches_cpu(cuda_device):
    """Two steps of each plan task on the card and on the CPU from the same
    weights and batches: the same first losses (TOL) and close last ones
    (1e-3: one AdamW update, whose first step is near the gradient's sign,
    lies between them)."""
    card = om.init_embedder(5)
    cpu = _cpu_twin(card)
    costs = [1e-3 * (i + 1) for i in range(6)]
    runs = {}
    for name, emb, dev in (("card", card, cuda_device), ("cpu", cpu, "cpu")):
        plans, cats = zip(*_queries(dev))
        runs[name] = (om.train_query2vec(emb, plans, cats, steps=2, batch=3),
                      om.train_latency(emb, plans, cats, costs, steps=2, batch=3))
    for rc, rp in zip(runs["card"], runs["cpu"]):
        assert rc["loss_first"] == pytest.approx(rp["loss_first"], rel=TOL, abs=TOL)
        assert rc["loss_last"] == pytest.approx(rp["loss_last"], rel=1e-3, abs=1e-5)
