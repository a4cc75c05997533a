"""QueryEmbedder: bundles Model2Vec + Query2Vec + latency head with their
training loops (contrastive Task-1 over WL pairs, latency Task-2), and the
glue that turns them into the reusable MCTS's embed_fn / learned cost_fn.
The port of ``repro.core.optimizer``.

Where the reference jits ``query2vec_apply`` (every input shape static: 32
plan slots of 64 graph nodes), ``embed`` and ``predict_latency`` run their
one-plan forward on the card through a ``plan_cache.CapturedGraph`` per
forward, captured at its first call; a capture that fails raises. On the
CPU they run eagerly. Embeddings come back as numpy, as ``NodeIndex``
keeps them.

Training is eager autograd and ``train.optim.AdamW`` over the modules'
parameters, with batches and mined triples drawn from the same
``np.random.default_rng(seed)`` calls as the reference's, so both packages
train on the same indices. The modules hold their weights without
gradients; a step differentiates a copy through ``torch.func.functional_call``
and the trained values are copied back at the end. Every training function
drops the captured graphs, which hold the old weights; the embedding cache
is cleared where the reference clears it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from repro_torch.core import embedding as E
from repro_torch.core import ir, wl
from repro_torch.core.plan_cache import CapturedGraph, LRUCache
from repro_torch.kernels.common import resolve_device
from repro_torch.train.optim import AdamW, tree_leaves, tree_map

EMBED_CACHE_SIZE = 4096  # embeddings are ~1.5KB; cap the store at a few MB


@dataclasses.dataclass
class QueryEmbedder:
    m2v: E.Model2Vec
    q2v: E.Query2Vec
    latency_q2v: E.Query2Vec   # separate copy for Task 2 (two-model strategy)
    latency_head: E.LatencyHead
    one_model: bool = False    # Sec. V-E baseline: joint training

    # LRU-bounded; mirrors the PlanCache interface (stats.hits/misses)
    _cache: LRUCache = dataclasses.field(
        default_factory=lambda: LRUCache(EMBED_CACHE_SIZE))
    # "embed" / "latency" -> the captured one-plan forward (the card only)
    _graphs: Dict[str, CapturedGraph] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for m in self.modules():
            m.requires_grad_(False)

    def modules(self) -> Tuple[nn.Module, ...]:
        return self.m2v, self.q2v, self.latency_q2v, self.latency_head

    @property
    def device(self) -> torch.device:
        return self.m2v.out.w.device

    @property
    def cache_stats(self):
        return self._cache.stats

    def drop_graphs(self) -> None:
        """Forget the captured forwards (they replay the weights they saw)."""
        self._graphs.clear()

    # -- forwards -----------------------------------------------------------
    def forward(self, kind: str, arrays) -> torch.Tensor:
        """The eager forward over stacked plan features [B, P, ...]:
        ``"embed"`` -> [B, 393] embeddings, ``"latency"`` -> [B] log
        latencies."""
        if kind == "embed":
            return E.query2vec_apply(self.q2v, self.m2v, arrays)
        q2v = self.q2v if self.one_model else self.latency_q2v
        return self.latency_head(E.query2vec_apply(q2v, self.m2v, arrays))

    def _run(self, kind: str, pf: E.PlanFeatures) -> np.ndarray:
        arrays = tuple(torch.from_numpy(a)[None] for a in E.pf_to_arrays(pf))
        with torch.no_grad(), E.no_tf32():
            if self.device.type != "cuda":
                out = self.forward(kind, arrays)
            else:
                graph = self._graphs.get(kind)
                if graph is None:
                    graph = CapturedGraph(lambda a: self.forward(kind, a), arrays,
                                          self.device)
                    self._graphs[kind] = graph
                out = graph.replay(arrays)
            return out[0].cpu().numpy()  # a copy out of the graph's pool

    # -- embedding ----------------------------------------------------------
    def embed(self, plan: ir.Plan, catalog: ir.Catalog) -> np.ndarray:
        key = plan.signature()
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        emb = self._run("embed", E.featurize_plan(plan, catalog))
        self._cache.put(key, emb)
        return emb

    def embed_expr(self, graph) -> np.ndarray:
        feats, mask = E.featurize_graph(graph)
        dev = self.device
        with torch.no_grad(), E.no_tf32():
            out = self.m2v(torch.from_numpy(feats)[None].to(dev),
                           torch.from_numpy(mask)[None].to(dev))
        return out[0].cpu().numpy()

    # -- latency prediction ---------------------------------------------------
    def predict_latency(self, plan: ir.Plan, catalog: ir.Catalog) -> float:
        log_lat = self._run("latency", E.featurize_plan(plan, catalog))
        return float(np.exp(log_lat))

    def learned_cost_fn(self, catalog: ir.Catalog) -> Callable:
        return lambda plan: self.predict_latency(plan, catalog)


def init_embedder(seed: int = 0, device=None) -> QueryEmbedder:
    """Random weights from ``seed`` (drawn on the CPU, so every device gets
    the same) on ``device``: the card unless the caller names one."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return QueryEmbedder(m2v=E.Model2Vec(gen).to(dev), q2v=E.Query2Vec(gen).to(dev),
                         latency_q2v=E.Query2Vec(gen).to(dev),
                         latency_head=E.LatencyHead(gen).to(dev))


# ===========================================================================
# pair mining (WL kernel) + training
# ===========================================================================

def mine_triples(items: Sequence, feats: Sequence, n_triples: int,
                 seed: int = 0) -> List[Tuple[int, int, int]]:
    """(anchor, positive, negative) index triples by WL cosine similarity."""
    rng = np.random.default_rng(seed)
    n = len(items)
    sims = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            s = wl.wl_similarity(feats[i], feats[j])
            sims[i, j] = sims[j, i] = s
    triples = []
    for _ in range(n_triples):
        a = int(rng.integers(0, n))
        order = np.argsort(-sims[a])
        order = order[order != a]
        if len(order) < 2:
            continue
        pos = int(order[0])
        neg = int(order[int(rng.integers(max(1, len(order) // 2), len(order)))])
        triples.append((a, pos, neg))
    return triples


# -- one step's loss, as a function of the trained parameters ----------------

def model2vec_loss(m2v: E.Model2Vec, params: dict, feats, masks, a, p, n):
    """Task-1 over graph triples: anchors, positives and negatives (index
    tensors into ``feats`` [G, 64, 30] / ``masks``) in one batched call."""
    idx = torch.cat([a, p, n])
    emb = functional_call(m2v, params, (feats[idx], masks[idx]))
    return E.contrastive_loss(*emb.chunk(3))


def query2vec_loss(q2v: E.Query2Vec, params: dict, e_expr, arrays, a, p, n):
    """Task-1 over plan triples; ``arrays`` are ``stack_features`` of the
    plans and ``e_expr`` their ``expr_embeddings`` (Model2Vec is fixed)."""
    idx = torch.cat([a, p, n])
    sel = tuple(x[idx] for x in arrays)
    return E.contrastive_loss(*functional_call(q2v, params, (e_expr[idx], sel)).chunk(3))


def latency_task_loss(q2v: E.Query2Vec, head: E.LatencyHead, params: dict,
                      e_expr, arrays, y, idx):
    """Task-2: MSE of the predicted log latency; ``params`` holds ``"q2v"``
    and ``"head"``."""
    sel = tuple(x[idx] for x in arrays)
    emb = functional_call(q2v, params["q2v"], (e_expr[idx], sel))
    return E.latency_loss(functional_call(head, params["head"], (emb,)), y[idx])


def _plan_inputs(embedder: QueryEmbedder, plans, catalogs):
    """The plans' stacked features on the embedder's device and their
    expression embeddings under its (fixed) Model2Vec. A plan's valid slots
    are a prefix of the 32 and masked slots change no valid one, so the
    slots past the longest plan are cut: the same function, less work."""
    arrays = E.stack_features([E.featurize_plan(p, c)
                               for p, c in zip(plans, catalogs)], embedder.device)
    n = max(int(arrays[-1].sum(1).max()), 1)
    arrays = tuple(a[:, :n] for a in arrays)
    with torch.no_grad(), E.no_tf32():
        return arrays, E.expr_embeddings(embedder.m2v, arrays)


def _weights(module: nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _set_weights(module: nn.Module, params: dict) -> None:
    with torch.no_grad():
        for k, v in module.named_parameters():
            v.copy_(params[k])


def _fit(params, loss_fn: Callable, batches, lr: float):
    """AdamW steps of ``loss_fn(params, *batch)``: the trained params and
    the loss of every step."""
    opt = AdamW(lr=lr)
    state = opt.init(params)
    hist = []
    with E.no_tf32():
        for batch in batches:
            leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = loss_fn(leaves, *batch)
            grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
            params, state = opt.update(tree_map(lambda _: next(grads), leaves),
                                       state, params)
            hist.append(loss.detach())
    return params, [float(h) for h in hist]


def _triple_batches(rng, triples, steps: int, batch: int, device):
    for _ in range(steps):
        idx = rng.integers(0, len(triples), batch)
        yield tuple(torch.tensor(x, device=device)
                    for x in zip(*[triples[j] for j in idx]))


def train_model2vec(embedder: QueryEmbedder, graphs: Sequence,
                    steps: int = 200, batch: int = 16, seed: int = 0,
                    lr: float = 3e-4) -> Dict:
    """Task-1 contrastive training for Model2Vec over sampled model graphs."""
    feats = [wl.graph_wl(g) for g in graphs]
    triples = mine_triples(graphs, feats, n_triples=max(steps * batch, 256),
                           seed=seed)
    enc = [E.featurize_graph(g) for g in graphs]
    dev = embedder.device
    fa = torch.from_numpy(np.stack([f for f, _ in enc])).to(dev)
    ma = torch.from_numpy(np.stack([m for _, m in enc])).to(dev)
    m2v = embedder.m2v
    params, hist = _fit(
        _weights(m2v), lambda p, a, pp, n: model2vec_loss(m2v, p, fa, ma, a, pp, n),
        _triple_batches(np.random.default_rng(seed), triples, steps, batch, dev), lr)
    _set_weights(m2v, params)
    embedder.drop_graphs()  # the reference keeps its embedding cache here
    return {"loss_first": hist[0], "loss_last": hist[-1]}


def train_query2vec(embedder: QueryEmbedder, plans, catalogs, steps: int = 200,
                    batch: int = 12, seed: int = 0, lr: float = 3e-4) -> Dict:
    """Task-1 contrastive training for Query2Vec over sampled queries."""
    feats = [wl.plan_wl(p.root, p.registry, phys=p.phys) for p in plans]
    triples = mine_triples(plans, feats, n_triples=max(steps * batch, 256),
                           seed=seed)
    arrays, e_expr = _plan_inputs(embedder, plans, catalogs)
    q2v = embedder.q2v
    params, hist = _fit(
        _weights(q2v), lambda p, a, pp, n: query2vec_loss(q2v, p, e_expr, arrays, a, pp, n),
        _triple_batches(np.random.default_rng(seed), triples, steps, batch,
                        embedder.device), lr)
    _set_weights(q2v, params)
    embedder.drop_graphs()
    embedder._cache.clear()
    return {"loss_first": hist[0], "loss_last": hist[-1]}


def train_latency(embedder: QueryEmbedder, plans, catalogs,
                  latencies: Sequence[float], steps: int = 300,
                  batch: int = 16, seed: int = 0, lr: float = 3e-4,
                  one_model: bool = False) -> Dict:
    """Task-2: latency head (4-layer FFNN, MSE on log latency).

    Two-model strategy (default): a separate Query2Vec copy (initialized from
    the contrastively-trained one) is fine-tuned jointly with the head.
    One-model: the shared Query2Vec is trained jointly (Sec. V-E baseline).
    """
    dev = embedder.device
    arrays, e_expr = _plan_inputs(embedder, plans, catalogs)
    # float32, as the reference's (jax runs with x64 off)
    y = torch.log(torch.from_numpy(np.asarray(latencies, np.float32)).to(dev) + 1e-9)
    if not one_model:
        embedder.latency_q2v.load_state_dict(embedder.q2v.state_dict())
    q2v = embedder.q2v if one_model else embedder.latency_q2v
    head = embedder.latency_head
    rng = np.random.default_rng(seed)
    batches = ((torch.as_tensor(rng.integers(0, len(plans), batch), device=dev),)
               for _ in range(steps))
    params, hist = _fit(
        {"q2v": _weights(q2v), "head": _weights(head)},
        lambda p, idx: latency_task_loss(q2v, head, p, e_expr, arrays, y, idx),
        batches, lr)
    _set_weights(q2v, params["q2v"])
    _set_weights(head, params["head"])
    if one_model:
        embedder.one_model = True
    embedder.drop_graphs()
    embedder._cache.clear()
    return {"loss_first": hist[0], "loss_last": hist[-1]}


def q_error(pred: np.ndarray, actual: np.ndarray) -> np.ndarray:
    pred = np.maximum(pred, 1e-12)
    actual = np.maximum(actual, 1e-12)
    return np.maximum(pred / actual, actual / pred)
