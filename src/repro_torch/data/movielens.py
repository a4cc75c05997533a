"""Synthetic MovieLens-shaped catalog (users, movies, ratings, tag relevance).

Proportions follow MovieLens-1M (6040 users / ~3900 movies / 1M ratings /
140,979-dim tag-relevance vectors from ML-32M), scaled by ``scale`` so the
engine runs interactively on CPU; scale=1.0 keeps the 3:2 user:movie ratio
with a 60x row reduction and a tag dimension of 4096.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ir import Catalog
from repro_torch.kernels.common import resolve_device
from repro_torch.relational.table import Table

N_GENRES = 18  # MovieLens genre count


def build(scale: float = 1.0, seed: int = 0, tag_dim: int = 4096, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_users = max(32, int(100 * scale))
    n_movies = max(24, int(66 * scale))
    n_ratings = max(128, int(1650 * scale))

    users = Table.from_columns({
        "user_id": np.arange(n_users, dtype=np.int32),
        "gender": np.asarray(rng.integers(0, 2, n_users), np.int32),
        "age": np.asarray(rng.integers(18, 80, n_users), np.float32),
        "occupation": np.asarray(rng.integers(0, 21, n_users), np.int32),
        "user_f": np.asarray(rng.standard_normal((n_users, 64)) * 0.5, np.float32),
    }, device=dev)
    movies = Table.from_columns({
        "movie_id": np.arange(n_movies, dtype=np.int32),
        "genre": np.asarray(rng.integers(0, N_GENRES, n_movies), np.int32),
        "year": np.asarray(rng.integers(1950, 2003, n_movies), np.float32),
        "movie_f": np.asarray(rng.standard_normal((n_movies, 32)) * 0.5, np.float32),
    }, device=dev)
    ratings = Table.from_columns({
        "r_user_id": np.asarray(rng.integers(0, n_users, n_ratings), np.int32),
        "r_movie_id": np.asarray(rng.integers(0, n_movies, n_ratings), np.int32),
        "rating": np.asarray(rng.integers(1, 6, n_ratings), np.float32),
    }, device=dev)
    # per-movie sparse tag-relevance vectors (high-dimensional; the paper's
    # AutoEncoder compresses these — the O3 memory story)
    tags = rng.standard_normal((n_movies, tag_dim)).astype(np.float32)
    tags *= (rng.random((n_movies, tag_dim)) < 0.05)  # sparse relevance
    movie_tags = Table.from_columns({
        "mt_movie_id": np.arange(n_movies, dtype=np.int32),
        "mt_relevance": tags,
    }, device=dev)

    cat = Catalog()
    cat.add("users", users)
    cat.add("movies", movies)
    cat.add("ratings", ratings)
    cat.add("movie_tags", movie_tags)
    return cat
