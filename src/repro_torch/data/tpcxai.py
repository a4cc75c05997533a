"""Synthetic TPCx-AI-shaped retailing catalog (order, store, customer,
financial accounts/transactions, product, product_rating)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.ir import Catalog
from repro_torch.kernels.common import resolve_device
from repro_torch.relational.table import Table


def build(scale: float = 1.0, seed: int = 1, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_store = max(8, int(12 * scale))
    n_order = max(64, int(800 * scale))
    n_cust = max(32, int(200 * scale))
    n_txn = max(64, int(900 * scale))
    n_prod = max(24, int(80 * scale))
    n_rate = max(64, int(1200 * scale))

    store = Table.from_columns({
        "store": np.arange(n_store, dtype=np.int32),
        "store_f": np.asarray(rng.standard_normal((n_store, 24)) * 0.5, np.float32),
    }, device=dev)
    order = Table.from_columns({
        "o_order_id": np.arange(n_order, dtype=np.int32),
        "o_store": np.asarray(rng.integers(0, n_store, n_order), np.int32),
        "o_customer_sk": np.asarray(rng.integers(0, n_cust, n_order), np.int32),
        "weekday": np.asarray(rng.integers(0, 7, n_order), np.int32),
        "order_f": np.asarray(rng.standard_normal((n_order, 40)) * 0.5, np.float32),
    }, device=dev)
    customer = Table.from_columns({
        "c_customer_sk": np.arange(n_cust, dtype=np.int32),
        "c_cust_flag": np.asarray(rng.integers(0, 2, n_cust), np.int32),
        "c_birth_year": np.asarray(rng.integers(1940, 2005, n_cust), np.float32),
        "customer_f": np.asarray(rng.standard_normal((n_cust, 20)) * 0.5, np.float32),
    }, device=dev)
    account = Table.from_columns({
        "fa_customer_sk": np.arange(n_cust, dtype=np.int32),
        "transaction_limit": np.asarray(rng.random(n_cust) * 1e4, np.float32),
    }, device=dev)
    txn = Table.from_columns({
        "transactionID": np.arange(n_txn, dtype=np.int32),
        "senderID": np.asarray(rng.integers(0, n_cust, n_txn), np.int32),
        "amount": np.asarray(rng.random(n_txn) * 5e3, np.float32),
        "hour": np.asarray(rng.integers(0, 24, n_txn), np.float32),
        "txn_f": np.asarray(rng.standard_normal((n_txn, 12)) * 0.5, np.float32),
    }, device=dev)
    product = Table.from_columns({
        "p_product_id": np.arange(n_prod, dtype=np.int32),
        "department": np.asarray(rng.integers(0, 10, n_prod), np.int32),
        "product_f": np.asarray(rng.standard_normal((n_prod, 25)) * 0.5, np.float32),
    }, device=dev)
    rating = Table.from_columns({
        "pr_user_id": np.asarray(rng.integers(0, n_cust, n_rate), np.int32),
        "pr_product_id": np.asarray(rng.integers(0, n_prod, n_rate), np.int32),
        "pr_rating": np.asarray(rng.integers(1, 6, n_rate), np.float32),
    }, device=dev)

    cat = Catalog()
    cat.add("store", store)
    cat.add("order", order)
    cat.add("customer", customer)
    cat.add("financial_account", account)
    cat.add("financial_transactions", txn)
    cat.add("product", product)
    cat.add("product_rating", rating)
    return cat
