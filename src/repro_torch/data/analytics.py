"""Synthetic Credit Card / Expedia / Flights analytics catalogs
(paper Sec. V-C4; dimension/row counts reduced for the CPU container but
keeping the workload structure: single scan / 3-way join / 4-way join,
4-6 predicate filters, scalers, tree classifiers)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.ir import Catalog
from repro_torch.kernels.common import resolve_device
from repro_torch.relational.table import Table


def build_creditcard(scale: float = 1.0, seed: int = 2, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = max(256, int(2890 * scale))  # paper: 289k rows, 29 features
    cat = Catalog()
    cat.add("creditcard", Table.from_columns({
        "cc_id": np.arange(n, dtype=np.int32),
        "amount": np.asarray(rng.random(n) * 1e3, np.float32),
        "time": np.asarray(rng.random(n) * 24.0, np.float32),
        "cc_f": np.asarray(rng.standard_normal((n, 29)), np.float32),
    }, device=dev))
    return cat


def build_expedia(scale: float = 1.0, seed: int = 3, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_listing = max(128, int(790 * scale))  # paper: 79k rows, 3000 features
    n_hotel = max(32, int(100 * scale))
    n_search = max(32, int(120 * scale))
    cat = Catalog()
    cat.add("listings", Table.from_columns({
        "l_id": np.arange(n_listing, dtype=np.int32),
        "l_hotel_id": np.asarray(rng.integers(0, n_hotel, n_listing), np.int32),
        "l_search_id": np.asarray(rng.integers(0, n_search, n_listing), np.int32),
        "price": np.asarray(rng.random(n_listing) * 500, np.float32),
        "listing_f": np.asarray(rng.standard_normal((n_listing, 96)), np.float32),
    }, device=dev))
    cat.add("hotel", Table.from_columns({
        "h_id": np.arange(n_hotel, dtype=np.int32),
        "stars": np.asarray(rng.integers(1, 6, n_hotel), np.float32),
        "hotel_f": np.asarray(rng.standard_normal((n_hotel, 80)), np.float32),
    }, device=dev))
    cat.add("search", Table.from_columns({
        "s_id": np.arange(n_search, dtype=np.int32),
        "dest": np.asarray(rng.integers(0, 50, n_search), np.int32),
        "search_f": np.asarray(rng.standard_normal((n_search, 80)), np.float32),
    }, device=dev))
    return cat


def build_flights(scale: float = 1.0, seed: int = 4, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_routes = max(128, int(700 * scale))  # paper: 7k rows, 6000 features
    n_airlines = max(16, int(60 * scale))
    n_airports = max(32, int(120 * scale))
    cat = Catalog()
    cat.add("routes", Table.from_columns({
        "rt_id": np.arange(n_routes, dtype=np.int32),
        "rt_airline": np.asarray(rng.integers(0, n_airlines, n_routes), np.int32),
        "rt_src": np.asarray(rng.integers(0, n_airports, n_routes), np.int32),
        "rt_dst": np.asarray(rng.integers(0, n_airports, n_routes), np.int32),
        "stops": np.asarray(rng.integers(0, 3, n_routes), np.float32),
        "route_f": np.asarray(rng.standard_normal((n_routes, 128)), np.float32),
    }, device=dev))
    cat.add("airlines", Table.from_columns({
        "al_id": np.arange(n_airlines, dtype=np.int32),
        "active": np.asarray(rng.integers(0, 2, n_airlines), np.int32),
        "airline_f": np.asarray(rng.standard_normal((n_airlines, 64)), np.float32),
    }, device=dev))
    cat.add("src_airports", Table.from_columns({
        "sa_id": np.arange(n_airports, dtype=np.int32),
        "sa_country": np.asarray(rng.integers(0, 40, n_airports), np.int32),
        "sa_f": np.asarray(rng.standard_normal((n_airports, 64)), np.float32),
    }, device=dev))
    cat.add("dst_airports", Table.from_columns({
        "da_id": np.arange(n_airports, dtype=np.int32),
        "da_country": np.asarray(rng.integers(0, 40, n_airports), np.int32),
        "da_f": np.asarray(rng.standard_normal((n_airports, 64)), np.float32),
    }, device=dev))
    return cat
