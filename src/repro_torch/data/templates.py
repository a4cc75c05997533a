"""The 20 inference-query templates (Appendix N): 10 MovieLens + 10 TPCx-AI.

Each template samples a query with varying model architectures (layer/neuron
counts), filter predicates, and selectivities. ``sample_query(template_id,
seed, scale, device)`` returns (Plan, Catalog); catalogs are shared per
dataset family, scale and device.
Templates are split 14 in-distribution / 6 out-of-distribution exactly as in
Sec. V-C5 (OOD chosen by seed).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core import ir
from repro_torch.kernels.common import resolve_device
from repro_torch.mlfuncs import builders
from repro_torch.mlfuncs.registry import Registry
from repro_torch.data import movielens, tpcxai

_CATALOGS: Dict[str, ir.Catalog] = {}


def catalog(kind: str, scale: float = 1.0, device=None) -> ir.Catalog:
    """The dataset family's catalog at ``scale`` on ``device`` (the card
    unless named), built once per (family, scale, device)."""
    dev = resolve_device(device)
    key = f"{kind}@{scale}@{dev}"
    if key not in _CATALOGS:
        if kind == "ml":
            _CATALOGS[key] = movielens.build(scale, seed=7, tag_dim=1024,
                                             device=dev)
        else:
            _CATALOGS[key] = tpcxai.build(scale, seed=11, device=dev)
    return _CATALOGS[key]


def _ffnn_dims(rng, d_in, out=1):
    depth = int(rng.integers(1, 4))
    return [d_in] + [int(rng.integers(32, 256)) for _ in range(depth)] + [out]


# -------------------- MovieLens templates (1-10) ---------------------------

def _ml_t1(rng, cat, reg):  # two-tower pre-ranking (paper Q1)
    code = int(rng.integers(32, 128))
    tt = reg.register(builders.two_tower(
        "tt", [64, int(rng.integers(128, 400)), code],
        [32, int(rng.integers(128, 400)), code], seed=int(rng.integers(1e6))))
    trend = reg.register(builders.ffnn("trend", _ffnn_dims(rng, 32),
                                       seed=int(rng.integers(1e6))))
    trend.selectivity_hint = 0.5
    genres = tuple(rng.choice(18, size=int(rng.integers(1, 4)), replace=False).tolist())
    movie = ir.Filter(
        ir.Filter(ir.Scan("movies"), pred=ir.IsIn(ir.Col("genre"), genres)),
        pred=ir.Cmp(">", ir.Call("trend", (ir.Col("movie_f"),)),
                    ir.Const(float(rng.uniform(0.3, 0.7)))))
    return ir.Project(ir.CrossJoin(ir.Scan("users"), movie),
                      outputs=(("score", ir.Call("tt", (ir.Col("user_f"),
                                                        ir.Col("movie_f")))),),
                      keep=("user_id", "movie_id"))


def _ml_t2(rng, cat, reg):  # autoencoder + DLRM (paper Q2 family)
    code = int(rng.integers(64, 256))
    ae = reg.register(builders.autoencoder_encoder(
        "ae", 1024, int(rng.integers(512, 2048)), code, seed=int(rng.integers(1e6))))
    emb_u = reg.register(builders.ffnn("eu", [64, 64], acts=["identity"],
                                       seed=int(rng.integers(1e6))))
    emb_m = reg.register(builders.ffnn("em", [32, 64], acts=["identity"],
                                       seed=int(rng.integers(1e6))))
    dl = reg.register(builders.dlrm("dl", code, 64,
                                    [int(rng.integers(64, 256))],
                                    seed=int(rng.integers(1e6))))
    movie = ir.Join(ir.Scan("movies"), ir.Scan("movie_tags"),
                    "movie_id", "mt_movie_id")
    pairs = ir.Filter(ir.CrossJoin(ir.Scan("users"), movie),
                      pred=ir.Cmp(">", ir.Col("age"),
                                  ir.Const(float(rng.integers(25, 60)))))
    q = ir.Project(pairs, outputs=(("dense", ir.Call("ae", (ir.Col("mt_relevance"),))),),
                   keep=("user_id", "movie_id", "user_f", "movie_f"))
    return ir.Project(q, outputs=(("score", ir.Call("dl", (
        ir.Col("dense"), ir.Call("eu", (ir.Col("user_f"),)),
        ir.Call("em", (ir.Col("movie_f"),))))),), keep=("user_id", "movie_id"))


def _ml_t3(rng, cat, reg):  # dense-rep cosine search (paper Q3 family)
    code = int(rng.integers(64, 256))
    ae = reg.register(builders.autoencoder_encoder(
        "ae", 1024, int(rng.integers(256, 1024)), code, seed=int(rng.integers(1e6))))
    cos = reg.register(builders.two_tower("cos", [code, code], [code, code],
                                          seed=int(rng.integers(1e6))))
    genres = tuple(rng.choice(18, size=2, replace=False).tolist())
    left = ir.Project(
        ir.Join(ir.Filter(ir.Scan("movies"), pred=ir.IsIn(ir.Col("genre"), genres)),
                ir.Scan("movie_tags"), "movie_id", "mt_movie_id"),
        outputs=(("d1", ir.Call("ae", (ir.Col("mt_relevance"),))),),
        keep=("movie_id",))
    right = ir.Project(ir.Scan("movie_tags"),
                       outputs=(("d2", ir.Call("ae", (ir.Col("mt_relevance"),))),),
                       keep=("mt_movie_id",))
    return ir.Project(ir.CrossJoin(left, right),
                      outputs=(("rel", ir.Call("cos", (ir.Col("d1"), ir.Col("d2")))),),
                      keep=("movie_id", "mt_movie_id"))


def _ml_t4(rng, cat, reg):  # rating prediction over cross join
    f = reg.register(builders.concat_ffnn("rate", [64, 32],
                                          _ffnn_dims(rng, 96)[1:],
                                          seed=int(rng.integers(1e6))))
    pred = ir.Cmp(">", ir.Col("age"), ir.Const(float(rng.integers(20, 60))))
    return ir.Project(ir.Filter(ir.CrossJoin(ir.Scan("users"), ir.Scan("movies")),
                                pred=pred),
                      outputs=(("rating", ir.Call("rate", (ir.Col("user_f"),
                                                           ir.Col("movie_f")))),),
                      keep=("user_id", "movie_id"))


def _ml_t5(rng, cat, reg):  # user opinion over users only
    f = reg.register(builders.ffnn("opinion", _ffnn_dims(rng, 64, out=3),
                                   acts=None, seed=int(rng.integers(1e6))))
    return ir.Project(
        ir.Filter(ir.Scan("users"),
                  pred=ir.Cmp("<", ir.Col("occupation"),
                              ir.Const(float(rng.integers(5, 20))))),
        outputs=(("opinion", ir.Call("opinion", (ir.Col("user_f"),))),),
        keep=("user_id",))


def _ml_t6(rng, cat, reg):  # SVD recommendation
    svd = reg.register(builders.svd_score(
        "svd", cat.stats["users"].capacity, cat.stats["movies"].capacity,
        int(rng.integers(16, 128)), seed=int(rng.integers(1e6))))
    return ir.Project(ir.Filter(ir.CrossJoin(ir.Scan("users"), ir.Scan("movies")),
                                pred=ir.IsIn(ir.Col("genre"),
                                             tuple(rng.choice(18, 3, replace=False).tolist()))),
                      outputs=(("pred", ir.Call("svd", (ir.Col("user_id"),
                                                        ir.Col("movie_id")))),),
                      keep=("user_id", "movie_id"))


def _ml_t7(rng, cat, reg):  # collaborative filtering on rating rows
    svd = reg.register(builders.svd_score(
        "cf", cat.stats["users"].capacity, cat.stats["movies"].capacity,
        int(rng.integers(16, 96)), seed=int(rng.integers(1e6))))
    return ir.Project(ir.Scan("ratings"),
                      outputs=(("pred", ir.Call("cf", (ir.Col("r_user_id"),
                                                       ir.Col("r_movie_id")))),),
                      keep=("r_user_id", "r_movie_id", "rating"))


def _ml_t8(rng, cat, reg):  # autoencoder dense rep per movie
    ae = reg.register(builders.autoencoder_encoder(
        "ae8", 1024, int(rng.integers(256, 1024)), int(rng.integers(32, 128)),
        seed=int(rng.integers(1e6))))
    return ir.Project(ir.Scan("movie_tags"),
                      outputs=(("dense", ir.Call("ae8", (ir.Col("mt_relevance"),))),),
                      keep=("mt_movie_id",))


def _ml_t9(rng, cat, reg):  # stereotype DNN over ratings x movies join
    f = reg.register(builders.ffnn("ster", _ffnn_dims(rng, 32),
                                   seed=int(rng.integers(1e6))))
    j = ir.Join(ir.Scan("ratings"), ir.Scan("movies"), "r_movie_id", "movie_id")
    return ir.Project(
        ir.Filter(j, pred=ir.Cmp(">", ir.Col("rating"),
                                 ir.Const(float(rng.integers(2, 5))))),
        outputs=(("flag", ir.Call("ster", (ir.Col("movie_f"),))),),
        keep=("r_user_id", "r_movie_id"))


def _ml_t10(rng, cat, reg):  # rating prediction, user x movie
    f = reg.register(builders.concat_ffnn("rp", [64, 32],
                                          _ffnn_dims(rng, 96)[1:],
                                          seed=int(rng.integers(1e6))))
    return ir.Project(
        ir.Filter(ir.CrossJoin(ir.Scan("users"), ir.Scan("movies")),
                  pred=ir.BoolOp("and", (
                      ir.Cmp(">", ir.Col("age"), ir.Const(float(rng.integers(20, 50)))),
                      ir.Cmp("<", ir.Col("year"), ir.Const(float(rng.integers(1970, 2002))))))),
        outputs=(("rating", ir.Call("rp", (ir.Col("user_f"), ir.Col("movie_f")))),),
        keep=("user_id", "movie_id"))


# -------------------- TPCx-AI templates (11-20) -----------------------------

def _tp_t1(rng, cat, reg):  # trip classification (retail q1 family)
    pop = reg.register(builders.ffnn("pop", _ffnn_dims(rng, 24),
                                     seed=int(rng.integers(1e6))))
    pop.selectivity_hint = 0.5
    clf = reg.register(builders.concat_ffnn("clf", [40, 24],
                                            _ffnn_dims(rng, 64)[1:],
                                            seed=int(rng.integers(1e6))))
    return ir.Project(
        ir.Filter(
            ir.Filter(ir.Join(ir.Scan("order"), ir.Scan("store"), "o_store", "store"),
                      pred=ir.Cmp("!=", ir.Col("weekday"),
                                  ir.Const(float(rng.integers(0, 7))))),
            pred=ir.Cmp(">", ir.Call("pop", (ir.Col("store_f"),)),
                        ir.Const(float(rng.uniform(0.3, 0.7))))),
        outputs=(("trip", ir.Call("clf", (ir.Col("order_f"), ir.Col("store_f")))),),
        keep=("o_order_id",))


def _tp_t2(rng, cat, reg):  # dual-model fraud (retail q2 family)
    xgb = reg.register(builders.decision_forest(
        "xgb", int(rng.integers(32, 200)), int(rng.integers(4, 7)), 32,
        seed=int(rng.integers(1e6))))
    feat = reg.register(builders.concat_ffnn("ff", [20, 12], [32, 32],
                                             out_act="identity",
                                             seed=int(rng.integers(1e6))))
    dnn = reg.register(builders.concat_ffnn("dnn", [20, 12],
                                            _ffnn_dims(rng, 32)[1:],
                                            seed=int(rng.integers(1e6))))
    cust = ir.Join(ir.Scan("customer"), ir.Scan("financial_account"),
                   "c_customer_sk", "fa_customer_sk")
    j = ir.Join(ir.Scan("financial_transactions"), cust, "senderID", "c_customer_sk")
    j = ir.Filter(j, pred=ir.Cmp(">", ir.Col("amount"),
                                 ir.Const(float(rng.integers(50, 2000)))))
    q = ir.Project(j, outputs=(("fx", ir.Call("ff", (ir.Col("customer_f"),
                                                     ir.Col("txn_f")))),),
                   keep=("transactionID", "customer_f", "txn_f"))
    return ir.Project(q, outputs=(
        ("xg", ir.Call("xgb", (ir.Col("fx"),))),
        ("dn", ir.Call("dnn", (ir.Col("customer_f"), ir.Col("txn_f"))))),
        keep=("transactionID",))


def _tp_t3(rng, cat, reg):  # two-tower product ranking (retail q3 family)
    code = int(rng.integers(8, 32))
    tt = reg.register(builders.two_tower(
        "ttp", [20, int(rng.integers(64, 256)), code],
        [25, int(rng.integers(64, 256)), code], seed=int(rng.integers(1e6))))
    agg = ir.Aggregate(ir.Scan("product_rating"), key="pr_product_id",
                       aggs=(("avg_r", ("mean", "pr_rating")),),
                       num_groups=cat.stats["product"].capacity)
    prod = ir.Filter(ir.Join(ir.Scan("product"), agg, "p_product_id", "pr_product_id"),
                     pred=ir.Cmp(">=", ir.Col("avg_r"),
                                 ir.Const(float(rng.uniform(2.0, 4.0)))))
    return ir.Project(ir.CrossJoin(ir.Scan("customer"), prod),
                      outputs=(("rank", ir.Call("ttp", (ir.Col("customer_f"),
                                                        ir.Col("product_f")))),),
                      keep=("c_customer_sk", "p_product_id"))


def _tp_t4(rng, cat, reg):  # SVD product rating
    svd = reg.register(builders.svd_score(
        "svdp", cat.stats["customer"].capacity, cat.stats["product"].capacity,
        int(rng.integers(16, 96)), seed=int(rng.integers(1e6))))
    j = ir.Join(ir.Scan("product_rating"), ir.Scan("product"),
                "pr_product_id", "p_product_id")
    return ir.Project(
        ir.Filter(j, pred=ir.Cmp("<", ir.Col("department"),
                                 ir.Const(float(rng.integers(3, 9))))),
        outputs=(("pred", ir.Call("svdp", (ir.Col("pr_user_id"),
                                           ir.Col("pr_product_id")))),),
        keep=("pr_user_id", "pr_product_id"))


def _tp_t5(rng, cat, reg):  # spam/anomaly detection on transactions
    f = reg.register(builders.ffnn("spam", _ffnn_dims(rng, 12),
                                   seed=int(rng.integers(1e6))))
    return ir.Project(
        ir.Filter(ir.Scan("financial_transactions"),
                  pred=ir.Cmp(">", ir.Col("hour"),
                              ir.Const(float(rng.integers(4, 20))))),
        outputs=(("spam", ir.Call("spam", (ir.Col("txn_f"),))),),
        keep=("transactionID",))


def _tp_t6(rng, cat, reg):  # trip classification forest
    forest = reg.register(builders.decision_forest(
        "tripf", int(rng.integers(20, 120)), int(rng.integers(4, 8)), 40,
        seed=int(rng.integers(1e6))))
    return ir.Project(
        ir.Join(ir.Scan("order"), ir.Scan("store"), "o_store", "store"),
        outputs=(("trip", ir.Call("tripf", (ir.Col("order_f"),))),),
        keep=("o_order_id",))


def _tp_t7(rng, cat, reg):  # logistic regression fraud
    lr = reg.register(builders.concat_ffnn("lrf", [12, 1, 1], [1],
                                           seed=int(rng.integers(1e6))))
    j = ir.Join(ir.Scan("financial_transactions"), ir.Scan("financial_account"),
                "senderID", "fa_customer_sk")
    return ir.Project(
        ir.Filter(j, pred=ir.Cmp(">", ir.Col("amount"),
                                 ir.Const(float(rng.integers(100, 3000))))),
        outputs=(("prob", ir.Call("lrf", (ir.Col("txn_f"), ir.Col("amount"),
                                          ir.Col("transaction_limit")))),),
        keep=("transactionID",))


def _tp_t8(rng, cat, reg):  # sales prediction per store
    f = reg.register(builders.ffnn("sales", _ffnn_dims(rng, 24),
                                   seed=int(rng.integers(1e6))))
    return ir.Project(ir.Scan("store"),
                      outputs=(("sales", ir.Call("sales", (ir.Col("store_f"),))),),
                      keep=("store",))


def _tp_t9(rng, cat, reg):  # customer segmentation (k-means)
    km = reg.register(builders.kmeans_assign("seg", int(rng.integers(3, 9)), 20,
                                             seed=int(rng.integers(1e6))))
    return ir.Project(
        ir.Filter(ir.Scan("customer"),
                  pred=ir.Cmp(">", ir.Col("c_birth_year"),
                              ir.Const(float(rng.integers(1950, 1995))))),
        outputs=(("cluster", ir.Call("seg", (ir.Col("customer_f"),))),),
        keep=("c_customer_sk",))


def _tp_t10(rng, cat, reg):  # customer satisfaction cross join
    f = reg.register(builders.concat_ffnn("sat", [20, 25],
                                          _ffnn_dims(rng, 45)[1:],
                                          seed=int(rng.integers(1e6))))
    return ir.Project(
        ir.Filter(ir.CrossJoin(ir.Scan("customer"), ir.Scan("product")),
                  pred=ir.Cmp("<", ir.Col("department"),
                              ir.Const(float(rng.integers(3, 10))))),
        outputs=(("sat", ir.Call("sat", (ir.Col("customer_f"),
                                         ir.Col("product_f")))),),
        keep=("c_customer_sk", "p_product_id"))


TEMPLATES = {
    1: ("ml", _ml_t1), 2: ("ml", _ml_t2), 3: ("ml", _ml_t3), 4: ("ml", _ml_t4),
    5: ("ml", _ml_t5), 6: ("ml", _ml_t6), 7: ("ml", _ml_t7), 8: ("ml", _ml_t8),
    9: ("ml", _ml_t9), 10: ("ml", _ml_t10),
    11: ("tp", _tp_t1), 12: ("tp", _tp_t2), 13: ("tp", _tp_t3),
    14: ("tp", _tp_t4), 15: ("tp", _tp_t5), 16: ("tp", _tp_t6),
    17: ("tp", _tp_t7), 18: ("tp", _tp_t8), 19: ("tp", _tp_t9),
    20: ("tp", _tp_t10),
}


def ood_split(seed: int = 42) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """14 in-distribution / 6 out-of-distribution template ids."""
    rng = np.random.default_rng(seed)
    ood = tuple(sorted(rng.choice(np.arange(1, 21), size=6, replace=False).tolist()))
    ind = tuple(t for t in range(1, 21) if t not in ood)
    return ind, ood


def sample_query(template_id: int, seed: int, scale: float = 1.0,
                 device=None) -> Tuple[ir.Plan, ir.Catalog]:
    kind, fn = TEMPLATES[template_id]
    cat = catalog(kind, scale, device)
    rng = np.random.default_rng(seed)
    reg = Registry()
    root = fn(rng, cat, reg)
    return ir.Plan(root, reg), cat
