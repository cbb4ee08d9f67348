"""The ranking stack's end-to-end MovieLens gate on the PyTorch port, on the
CPU: ``tests/test_acceptance_movielens.py``'s fixture (synthetic
ml-1m-format files with genre preferences, ~1,000 ratings, preprocessed at
``data_size=1000``) and floors (the mean of the last 5 epoch losses < 0.5,
recall@12 > 0.0015, precision@12 > 0.01, no truncations) through the port's
``preprocess`` → ``create_link_pred_data_from_artifacts`` →
``run_pipeline``, at the reference's config (100 epochs, seed 42, k 12,
batch 24, 64 neighbours, 3 hops, hidden 128 / 64)."""
import os

import numpy as np
import pytest

from laplace_gnn_recommendation_tpu_torch.configs import Config, preprocessing_config
from laplace_gnn_recommendation_tpu_torch.data import preprocess_movielens
from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import (
    create_link_pred_data_from_artifacts,
)
from laplace_gnn_recommendation_tpu_torch.train.encdec_pipeline import run_pipeline


@pytest.fixture(scope="module")
def ml_artifacts(tmp_path_factory):
    """Synthetic ml-1m-format raw data (~1,000 ratings), preprocessed with
    the shipped preprocessing config capped at data_size=1000 (the
    reference acceptance setting, its ``tests/test_acceptance_movielens.py:
    10-14``)."""
    raw = tmp_path_factory.mktemp("ml_raw")
    rng = np.random.default_rng(42)
    # density ~7% — a dense-random BCE target needs negatives that are
    # mostly true negatives, like the real ml-1m 1k-transaction slice
    n_users, n_movies = 50, 300
    users = [
        f"{i}::{'FM'[i % 2]}::{18 + (i % 5) * 10}::{i % 20}::5511{i % 10}"
        for i in range(1, n_users + 1)
    ]
    (raw / "users.dat").write_text("\n".join(users) + "\n")
    genres = ["Comedy", "Drama", "Action", "Thriller", "Romance"]
    movies = [
        f"{i}::Movie {i} (19{90 + i % 10})::{genres[i % 5]}|{genres[(i + 2) % 5]}"
        for i in range(1, n_movies + 1)
    ]
    (raw / "movies.dat").write_text("\n".join(movies) + "\n")
    rows, ts = [], 956700000
    per_user = 1000 // n_users
    # genre-preference structure (what real ml-1m has and a dense-random
    # target lacks; see tests/test_acceptance_movielens.py): user u prefers
    # genre u%5; movie i carries genres {i%5, (i+2)%5}, so 2/5 of the
    # catalog is preferred.
    # 80% of each user's ratings come from the preferred pool.
    movie_ids = np.arange(1, n_movies + 1)
    for u in range(1, n_users + 1):
        g = u % 5
        pool = movie_ids[(movie_ids % 5 == g) | ((movie_ids + 2) % 5 == g)]
        n_pref = int(round(per_user * 0.8))
        picks = np.concatenate([
            rng.choice(pool, n_pref, replace=False),
            rng.choice(movie_ids, per_user - n_pref, replace=False),
        ])
        # dedup (a random pick may repeat a preferred one), top back up
        picks = np.unique(picks)
        while len(picks) < per_user:
            extra = rng.choice(movie_ids, per_user - len(picks), replace=False)
            picks = np.unique(np.concatenate([picks, extra]))
        for m in picks[:per_user]:
            ts += 60
            rows.append(f"{u}::{m}::{rng.integers(1, 6)}::{ts}")
    (raw / "ratings.dat").write_text("\n".join(rows) + "\n")

    art = str(tmp_path_factory.mktemp("ml_derived"))
    import dataclasses

    cfg = dataclasses.replace(preprocessing_config, data_size=1000)
    preprocess_movielens.preprocess(cfg, str(raw), art)
    return art


class TestAcceptanceMovieLens:
    def test_pipeline(self, ml_artifacts):
        # reference config: 100 epochs at seed 42, matching the
        # reference acceptance run exactly
        cfg = Config(
            epochs=100, k=12, num_gnn_layers=2, num_linear_layers=2,
            hidden_layer_size=128, encoder_layer_output_size=64,
            conv_agg_type="add", heterogeneous_prop_agg_type="sum",
            learning_rate=0.01, batch_size=24, num_neighbors=64,
            n_hop_neighbors=3, candidate_pool_size=20,
            positive_edges_ratio=0.5, negative_edges_ratio=3.0,
            eval_every=4, seed=42,
        )
        data, _ = create_link_pred_data_from_artifacts(ml_artifacts, cfg, device="cpu")
        stats = run_pipeline(cfg, data, log_fn=lambda *_: None, device="cpu")
        # the reference's floors; the loss floor on the mean of the last 5
        # epoch losses (the single final-epoch loss oscillates ±0.03 here)
        assert float(np.mean(stats.loss_curve[-5:])) < 0.5, stats.loss_curve[-10:]
        assert stats.recall_test > 0.0015
        assert stats.precision_test > 0.01
        # a healthy run never drops edges, labels or nodes to its budgets
        assert stats.truncations and all(
            v == 0 for v in stats.truncations.values()
        ), stats.truncations
