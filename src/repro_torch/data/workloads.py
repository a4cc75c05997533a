"""The paper's 12 representative inference workloads as three-level-IR plans.

Each builder returns a ``Workload`` (name, Plan, Catalog, memory budget).
ML filter selectivities are measured exactly against the base data at build
time (the role of the paper's statistics/sample features), making them sound
upper bounds for Compact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.mlfuncs import builders
from repro_torch.mlfuncs.registry import Registry
from repro_torch.data import movielens, tpcxai, analytics
from repro_torch.relational.table import Table


@dataclasses.dataclass
class Workload:
    name: str
    plan: ir.Plan
    catalog: ir.Catalog
    memory_budget: float = 512e6  # bytes; the paper's 61GB box, scaled


def roll_tables(tables, shift: int):
    """One legal parameterized instance of ``tables`` (a Table or a dict of
    them): every column and the valid mask roll together by ``shift`` rows,
    so row integrity (join keys, masks) is preserved while the contents
    differ from the original. The canonical way tests and benchmarks
    fabricate same-signature traffic."""
    if isinstance(tables, Table):
        return Table(columns={k: torch.roll(v, shift, dims=0)
                              for k, v in tables.columns.items()},
                     valid=torch.roll(tables.valid, shift, dims=0))
    return {name: roll_tables(t, shift) for name, t in tables.items()}


def rolled_instances(tables, n: int):
    """N same-schema parameterized instances (shift 0..n-1)."""
    return [roll_tables(tables, i) for i in range(n)]


def _measured_sel(fn, table_np, cols, thresh=0.5, op=">"):
    """Exact selectivity of `fn(cols...) op thresh` on the base table."""
    args = [torch.as_tensor(table_np[c]) for c in cols]  # on the CPU
    out = fn.apply(*args).numpy()
    if out.ndim == 2 and out.shape[1] == 1:
        out = out[:, 0]
    frac = float(np.mean(out > thresh) if op == ">" else np.mean(out < thresh))
    return min(1.0, frac + 1e-6)


# ===========================================================================
# Recommendation queries (MovieLens; paper Sec. V-C1)
# ===========================================================================

def rec_q1(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """Q1: aggregate user/movie avg ratings, genre LIKE filter + trending
    DNN filter on movies, crossJoin users, two-tower scoring."""
    cat = movielens.build(scale, seed, device=device)
    reg = Registry()
    n_users = cat.stats["users"].rows
    n_movies = cat.stats["movies"].rows
    # user tower input: user_f(64) + avg_rating(1)=concat'd at query time via
    # vector col + scalar; towers take the 64-d and 32-d features directly
    tt = reg.register(builders.two_tower("two_tower", [64, 300, 128],
                                         [32, 300, 128], seed=seed + 1))
    trend = builders.ffnn("trending_movie_dnn", [32, 128, 64, 1], seed=seed + 2)
    reg.register(trend)
    trend.selectivity_hint = _measured_sel(trend, cat.np_tables["movies"],
                                           ["movie_f"], 0.5)

    movie_side = ir.Filter(
        ir.Filter(
            ir.Scan("movies"),
            pred=ir.IsIn(ir.Col("genre"), (1, 4, 7)),  # LIKE '%Action%'
        ),
        pred=ir.Cmp(">", ir.Call("trending_movie_dnn", (ir.Col("movie_f"),)),
                    ir.Const(0.5)),
        selectivity=trend.selectivity_hint,
    )
    user_agg = ir.Aggregate(ir.Scan("ratings"), key="r_user_id",
                            aggs=(("user_avg_rating", ("mean", "rating")),),
                            num_groups=cat.stats["users"].capacity)
    user_side = ir.Join(ir.Scan("users"), user_agg, "user_id", "r_user_id")
    q = ir.Project(
        ir.CrossJoin(user_side, movie_side),
        outputs=(("score", ir.Call("two_tower", (ir.Col("user_f"), ir.Col("movie_f")))),),
        keep=("user_id", "movie_id", "user_avg_rating"))
    return Workload("rec_q1", ir.Plan(q, reg), cat)


def rec_q2(scale: float = 1.0, seed: int = 0, tag_dim: int = 4096,
           device=None) -> Workload:
    """Q2: trending + user-interest DNN prefilters, join movie tags, a LARGE
    AutoEncoder compresses the tag vector (the O3/OOM driver), DLRM scores."""
    cat = movielens.build(scale, seed, device=device, tag_dim=tag_dim)
    reg = Registry()
    trend = builders.ffnn("trending_movie_dnn", [32, 128, 64, 1], seed=seed + 2)
    reg.register(trend)
    trend.selectivity_hint = _measured_sel(trend, cat.np_tables["movies"],
                                           ["movie_f"], 0.45)
    interest = builders.concat_ffnn("user_interest_dnn", [64, 32], [128, 1],
                                    seed=seed + 3)
    reg.register(interest)
    interest.selectivity_hint = 0.5
    ae = builders.autoencoder_encoder("autoencoder", tag_dim, 2048, 256,
                                      seed=seed + 4)
    reg.register(ae)
    dlrm = builders.dlrm("dlrm", 256, 64, [128], seed=seed + 5)
    reg.register(dlrm)
    emb_u = reg.register(builders.ffnn("user_emb", [64, 64],
                                       acts=["identity"], seed=seed + 6))
    emb_m = reg.register(builders.ffnn("movie_emb", [32, 64],
                                       acts=["identity"], seed=seed + 7))

    movie_side = ir.Join(
        ir.Filter(ir.Scan("movies"),
                  pred=ir.Cmp(">", ir.Call("trending_movie_dnn", (ir.Col("movie_f"),)),
                              ir.Const(0.45)),
                  selectivity=trend.selectivity_hint),
        ir.Scan("movie_tags"), "movie_id", "mt_movie_id")
    pairs = ir.Filter(
        ir.CrossJoin(ir.Scan("users"), movie_side),
        pred=ir.Cmp(">", ir.Call("user_interest_dnn",
                                 (ir.Col("user_f"), ir.Col("movie_f"))),
                    ir.Const(0.5)),
        selectivity=0.6)
    q = ir.Project(
        pairs,
        outputs=(("dense_rep", ir.Call("autoencoder", (ir.Col("mt_relevance"),))),),
        keep=("user_id", "movie_id", "user_f", "movie_f"))
    q = ir.Project(
        q,
        outputs=(("rec_score", ir.Call("dlrm", (ir.Col("dense_rep"),
                                                ir.Call("user_emb", (ir.Col("user_f"),)),
                                                ir.Call("movie_emb", (ir.Col("movie_f"),))))),),
        keep=("user_id", "movie_id"))
    return Workload("rec_q2", ir.Plan(q, reg), cat,
                    memory_budget=256e6)


def rec_q3(scale: float = 1.0, seed: int = 0, tag_dim: int = 4096,
           device=None) -> Workload:
    """Q3: interest + rating DNN filters, AutoEncoder dense reps for two
    movie sets, cosine-similarity vector search over the cross join."""
    cat = movielens.build(scale, seed, device=device, tag_dim=tag_dim)
    reg = Registry()
    interest = builders.concat_ffnn("user_interest_dnn", [64, 32], [128, 1],
                                    seed=seed + 3)
    reg.register(interest)
    ae = builders.autoencoder_encoder("autoencoder", tag_dim, 2048, 256,
                                      seed=seed + 4)
    reg.register(ae)
    cos = builders.two_tower("cos_sim", [256, 256], [256, 256], seed=seed + 5)
    reg.register(cos)

    left = ir.Project(
        ir.Join(
            ir.Filter(ir.Scan("movies"), pred=ir.IsIn(ir.Col("genre"), (2, 5, 9))),
            ir.Scan("movie_tags"), "movie_id", "mt_movie_id"),
        outputs=(("dense1", ir.Call("autoencoder", (ir.Col("mt_relevance"),))),),
        keep=("movie_id",))
    right = ir.Project(
        ir.Scan("movie_tags"),
        outputs=(("dense2", ir.Call("autoencoder", (ir.Col("mt_relevance"),))),),
        keep=("mt_movie_id",))
    q = ir.Project(
        ir.CrossJoin(left, right),
        outputs=(("relevant_score", ir.Call("cos_sim", (ir.Col("dense1"), ir.Col("dense2")))),),
        keep=("movie_id", "mt_movie_id"))
    return Workload("rec_q3", ir.Plan(q, reg), cat, memory_budget=256e6)


# ===========================================================================
# Retailing-Complex queries (TPCx-AI; paper Sec. V-C2)
# ===========================================================================

def retail_q1(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """Q1: order x store join, is_popular_store ML filter, trip classifier
    FFNN over concat(order_f, store_f) — the R2-1 factorization target."""
    cat = tpcxai.build(scale, seed, device=device)
    reg = Registry()
    pop = builders.ffnn("is_popular_store", [24, 32, 1], seed=seed + 1)
    reg.register(pop)
    pop.selectivity_hint = _measured_sel(pop, cat.np_tables["store"],
                                         ["store_f"], 0.5)
    clf = builders.concat_ffnn("trip_classifier_dnn", [40, 24], [48, 32, 1],
                               seed=seed + 2)
    reg.register(clf)

    q = ir.Project(
        ir.Filter(
            ir.Filter(
                ir.Join(ir.Scan("order"), ir.Scan("store"), "o_store", "store"),
                pred=ir.Cmp("!=", ir.Col("weekday"), ir.Const(6))),
            pred=ir.Cmp(">", ir.Call("is_popular_store", (ir.Col("store_f"),)),
                        ir.Const(0.5)),
            selectivity=pop.selectivity_hint),
        outputs=(("trip_class", ir.Call("trip_classifier_dnn",
                                        (ir.Col("order_f"), ir.Col("store_f")))),),
        keep=("o_order_id",))
    return Workload("retail_q1", ir.Plan(q, reg), cat)


def retail_q2(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """Q2: per-customer aggregates joined with transactions + accounts;
    XGBoost forest AND DNN must both flag fraud — the R3-2 target."""
    cat = tpcxai.build(scale, seed, device=device)
    reg = Registry()
    xgb = builders.decision_forest("xgboost_fraud", n_trees=160, depth=6,
                                   n_features=32, seed=seed + 1)
    reg.register(xgb)
    dnn = builders.concat_ffnn("dnn_fraud", [20, 12], [12, 1], seed=seed + 2)
    reg.register(dnn)

    cust = ir.Join(ir.Scan("customer"), ir.Scan("financial_account"),
                   "c_customer_sk", "fa_customer_sk")
    cust = ir.Filter(cust, pred=ir.Cmp("==", ir.Col("c_cust_flag"), ir.Const(0)))
    joined = ir.Join(ir.Scan("financial_transactions"), cust,
                     "senderID", "c_customer_sk")
    joined = ir.Filter(joined, pred=ir.Cmp(">", ir.Col("amount"), ir.Const(100.0)))
    feat = ir.Project(
        joined,
        outputs=(("fraud_feat", ir.Call("concat2_q2", (ir.Col("customer_f"), ir.Col("txn_f")))),),
        keep=("transactionID", "customer_f", "txn_f"))
    concat2 = builders.concat_ffnn("concat2_q2", [20, 12], [32, 32],
                                   out_act="identity", seed=seed + 3)
    reg.register(concat2)
    q = ir.Filter(
        ir.Project(
            feat,
            outputs=(("xg_score", ir.Call("xgboost_fraud", (ir.Col("fraud_feat"),))),
                     ("dnn_score", ir.Call("dnn_fraud", (ir.Col("customer_f"), ir.Col("txn_f"))))),
            keep=("transactionID",)),
        pred=ir.BoolOp("and", (
            ir.Cmp(">=", ir.Col("xg_score"), ir.Const(0.0)),
            ir.Cmp(">", ir.Col("dnn_score"), ir.Const(0.5)))))
    return Workload("retail_q2", ir.Plan(q, reg), cat)


def retail_q3(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """Q3: aggregate product ratings, join products, crossJoin customers,
    two-tower product-customer ranking (the paper's biggest speedup)."""
    cat = tpcxai.build(scale, seed, device=device)
    reg = Registry()
    tt = builders.two_tower("two_tower_retail", [20, 128, 40, 16],
                            [25, 128, 40, 16], seed=seed + 1)
    reg.register(tt)

    prod_agg = ir.Aggregate(ir.Scan("product_rating"), key="pr_product_id",
                            aggs=(("prod_avg_rating", ("mean", "pr_rating")),),
                            num_groups=cat.stats["product"].capacity)
    prod = ir.Filter(
        ir.Join(ir.Scan("product"), prod_agg, "p_product_id", "pr_product_id"),
        pred=ir.Cmp(">=", ir.Col("prod_avg_rating"), ir.Const(3.0)))
    q = ir.Project(
        ir.CrossJoin(ir.Scan("customer"), prod),
        outputs=(("rank_score", ir.Call("two_tower_retail",
                                        (ir.Col("customer_f"), ir.Col("product_f")))),),
        keep=("c_customer_sk", "p_product_id"))
    return Workload("retail_q3", ir.Plan(q, reg), cat)


# ===========================================================================
# Retailing-Simplified queries (paper Sec. V-C3)
# ===========================================================================

def simple_q1(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """SVD product-rating factorization scoring."""
    cat = tpcxai.build(scale, seed, device=device)
    reg = Registry()
    svd = builders.svd_score("svd", cat.stats["customer"].capacity,
                             cat.stats["product"].capacity, 64, seed=seed + 1)
    reg.register(svd)
    q = ir.Project(ir.Scan("product_rating"),
                   outputs=(("pred_rating", ir.Call("svd", (ir.Col("pr_user_id"),
                                                            ir.Col("pr_product_id")))),),
                   keep=("pr_user_id", "pr_product_id", "pr_rating"))
    return Workload("simple_q1", ir.Plan(q, reg), cat)


def simple_q2(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """50-tree XGBoost trip classification over store x order join."""
    cat = tpcxai.build(scale, seed, device=device)
    reg = Registry()
    xgb = builders.decision_forest("xgboost_trip", n_trees=50, depth=6,
                                   n_features=40, seed=seed + 1)
    reg.register(xgb)
    q = ir.Project(
        ir.Join(ir.Scan("order"), ir.Scan("store"), "o_store", "store"),
        outputs=(("trip_type", ir.Call("xgboost_trip", (ir.Col("order_f"),))),),
        keep=("o_order_id",))
    return Workload("simple_q2", ir.Plan(q, reg), cat)


def simple_q3(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """Logistic-regression fraud detection over account x transaction join."""
    cat = tpcxai.build(scale, seed, device=device)
    reg = Registry()
    lr = builders.concat_ffnn("logreg_fraud", [12, 1, 1], [1], seed=seed + 1)
    reg.register(lr)
    joined = ir.Join(ir.Scan("financial_transactions"), ir.Scan("financial_account"),
                     "senderID", "fa_customer_sk")
    q = ir.Project(
        joined,
        outputs=(("fraud_prob", ir.Call("logreg_fraud",
                                        (ir.Col("txn_f"), ir.Col("amount"),
                                         ir.Col("transaction_limit")))),),
        keep=("transactionID",))
    return Workload("simple_q3", ir.Plan(q, reg), cat)


# ===========================================================================
# Analytics queries (paper Sec. V-C4)
# ===========================================================================

def analytics_q1(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """Credit Card fraud: single scan, predicate filters, scaler, 100-tree
    depth-9 ensemble."""
    cat = analytics.build_creditcard(scale, seed, device=device)
    reg = Registry()
    forest = builders.decision_forest("cc_forest", n_trees=100, depth=9,
                                      n_features=29, seed=seed + 1)
    reg.register(forest)
    q = ir.Project(
        ir.Filter(
            ir.Filter(ir.Scan("creditcard"),
                      pred=ir.Cmp("<", ir.Col("amount"), ir.Const(800.0))),
            pred=ir.Cmp(">", ir.Col("time"), ir.Const(2.0))),
        outputs=(("fraud", ir.Call("cc_forest", (ir.Col("cc_f"),))),),
        keep=("cc_id",))
    return Workload("analytics_q1", ir.Plan(q, reg), cat)


def analytics_q2(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """Expedia hotel ranking: 3-way join + single deep decision tree."""
    cat = analytics.build_expedia(scale, seed, device=device)
    reg = Registry()
    tree = builders.decision_forest("exp_tree", n_trees=1, depth=9,
                                    n_features=96, seed=seed + 1)
    reg.register(tree)
    j = ir.Join(ir.Join(ir.Scan("listings"), ir.Scan("hotel"), "l_hotel_id", "h_id"),
                ir.Scan("search"), "l_search_id", "s_id")
    q = ir.Project(
        ir.Filter(
            ir.Filter(j, pred=ir.Cmp("<", ir.Col("price"), ir.Const(400.0))),
            pred=ir.Cmp(">=", ir.Col("stars"), ir.Const(2.0))),
        outputs=(("rank", ir.Call("exp_tree", (ir.Col("listing_f"),))),),
        keep=("l_id",))
    return Workload("analytics_q2", ir.Plan(q, reg), cat)


def analytics_q3(scale: float = 1.0, seed: int = 0,
           device=None) -> Workload:
    """Flights codeshare: 4-way join + 100-tree ensemble."""
    cat = analytics.build_flights(scale, seed, device=device)
    reg = Registry()
    forest = builders.decision_forest("fl_forest", n_trees=100, depth=9,
                                      n_features=128, seed=seed + 1)
    reg.register(forest)
    j = ir.Join(
        ir.Join(
            ir.Join(ir.Scan("routes"), ir.Scan("airlines"), "rt_airline", "al_id"),
            ir.Scan("src_airports"), "rt_src", "sa_id"),
        ir.Scan("dst_airports"), "rt_dst", "da_id")
    q = ir.Project(
        ir.Filter(
            ir.Filter(j, pred=ir.Cmp("==", ir.Col("active"), ir.Const(1))),
            pred=ir.Cmp("<", ir.Col("stops"), ir.Const(2.0))),
        outputs=(("codeshare", ir.Call("fl_forest", (ir.Col("route_f"),))),),
        keep=("rt_id",))
    return Workload("analytics_q3", ir.Plan(q, reg), cat)


ALL_WORKLOADS = {
    "rec_q1": rec_q1, "rec_q2": rec_q2, "rec_q3": rec_q3,
    "retail_q1": retail_q1, "retail_q2": retail_q2, "retail_q3": retail_q3,
    "simple_q1": simple_q1, "simple_q2": simple_q2, "simple_q3": simple_q3,
    "analytics_q1": analytics_q1, "analytics_q2": analytics_q2,
    "analytics_q3": analytics_q3,
}
