"""The ranking sampler's truncation counters against the JAX package's.

One epoch of ``create_samplers(...)``'s train batches, no training, through
both packages with one seed, from the same ml-1m-format files preprocessed
by each package: ``sampler.truncations`` must be equal. Edges are counted
truncated where the Python assembly path cuts a batch's edge list at the
edge budget (JAX ``data/sampler.py:414``, the port's ``:440``); that path
runs when the native assembly reports that a budget would overflow.

The test forces the cut at a small size (``max_edges_per_batch``). Run as a
script, the module takes the files ``chip_smoke.write_movielens`` writes at
MovieLens-1M's size (1,000,209 ratings) and ``chip_smoke.RANK_CFG`` (the
artifacts path of its phase 8) and prints both packages' counters:

    JAX_PLATFORMS=cpu python tests/test_torch_sampler_truncation.py
"""
import dataclasses
import importlib
import json
import os
import sys
import tempfile

import numpy as np

PACKAGES = ("laplace_gnn_recommendation_tpu", "laplace_gnn_recommendation_tpu_torch")


def write_ratings(raw, n_users, n_movies, mean_per_user, seed=0):
    """ml-1m-format files with a heavy-tailed number of ratings a user."""
    rng = np.random.default_rng(seed)
    os.makedirs(raw, exist_ok=True)
    with open(os.path.join(raw, "users.dat"), "w") as f:
        f.write("".join(f"{u}::{'FM'[u % 2]}::25::{u % 21}::{10000 + u}\n"
                        for u in range(1, n_users + 1)))
    with open(os.path.join(raw, "movies.dat"), "w") as f:
        f.write("".join(f"{i}::Movie {i} (199{i % 10})::Comedy|Drama\n"
                        for i in range(1, n_movies + 1)))
    w = rng.lognormal(0.0, 0.8, n_users)
    counts = np.minimum(20 + rng.multinomial((mean_per_user - 20) * n_users, w / w.sum()),
                        n_movies)
    rows, ts = [], 956_700_000
    for u, n in zip(range(1, n_users + 1), counts):
        for m in rng.choice(np.arange(1, n_movies + 1), size=n, replace=False):
            ts += 100
            rows.append(f"{u}::{m}::4::{ts}\n")
    with open(os.path.join(raw, "ratings.dat"), "w") as f:
        f.write("".join(rows))


def epoch_truncations(package: str, raw: str, art: str, cfg_kw: dict) -> dict:
    """``package``'s preprocess of ``raw`` into ``art``, then one epoch of its
    train sampler; the sampler's truncation counters and budgets."""
    def mod(name):
        return importlib.import_module(f"{package}.{name}")

    configs = mod("configs")
    mod("data.preprocess_movielens").preprocess(
        dataclasses.replace(configs.preprocessing_config, data_size=None), raw, art)
    cfg = configs.Config(**cfg_kw)
    lpd = mod("data.link_pred_data")
    kw = {"device": "cpu"} if package.endswith("_torch") else {}
    data, _ = lpd.create_link_pred_data_from_artifacts(art, cfg, **kw)
    train_s, _, _ = lpd.create_samplers(cfg, data, seed=cfg.seed, randomization=True)
    batches = sum(1 for _ in train_s.epoch_batches(shuffle=True))
    return dict(truncations=dict(train_s.truncations), batches=batches,
                budgets=dataclasses.asdict(train_s.budgets))


def test_truncations_match_jax(tmp_path):
    raw = str(tmp_path / "raw")
    write_ratings(raw, 300, 200, 40)
    cfg_kw = dict(batch_size=32, num_neighbors=4, n_hop_neighbors=2, k=4,
                  candidate_pool_size=8, max_edges_per_batch=1000)
    jax_out, port_out = (epoch_truncations(p, raw, str(tmp_path / p), cfg_kw) for p in PACKAGES)
    assert port_out == jax_out
    assert port_out["truncations"]["edges"] > 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "raw")
        files = chip_smoke.write_movielens(raw)
        cfg_kw = dict(chip_smoke.RANK_CFG, epochs=chip_smoke.ML_EPOCHS, eval_every=1)
        out = {p: epoch_truncations(p, raw, os.path.join(tmp, p), cfg_kw) for p in PACKAGES}
    print(json.dumps(dict(files=files, config=cfg_kw, **out)))
