"""ETL in the PyTorch port: the ports of ``tests/test_etl.py``'s
``TestPrimitives``, ``TestMovieLensPreprocess`` and ``TestSubmission``;
``preprocess`` on the same raw files gives the JAX package's artifacts array
for array; an artifact directory written by either package loads in the
other; ``submission_pipeline`` from a checkpoint; and
``lightgcn_data_from_hetero`` against the JAX function. Everything here is
exact (integer arrays, id maps): no tolerance."""
import dataclasses
import os

import numpy as np
import pytest

from laplace_gnn_recommendation_tpu.configs import preprocessing_config as jpre_cfg
from laplace_gnn_recommendation_tpu.data import etl as jetl
from laplace_gnn_recommendation_tpu.data import lightgcn_data as jlgd
from laplace_gnn_recommendation_tpu.data import preprocess_movielens as jpml
from laplace_gnn_recommendation_tpu.data import synthetic as jsynth
from laplace_gnn_recommendation_tpu_torch.configs import Config, preprocessing_config
from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY, NODE_ITEM, NODE_USER
from laplace_gnn_recommendation_tpu_torch.data import preprocess_movielens
from laplace_gnn_recommendation_tpu_torch.data.etl import (
    create_ids_and_maps,
    encode_labels,
    filter_unconnected,
    load_artifacts,
    save_artifacts,
)
from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import lightgcn_data_from_hetero
from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import (
    create_link_pred_data_from_artifacts,
)
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
from laplace_gnn_recommendation_tpu_torch.train.encdec_pipeline import run_pipeline
from laplace_gnn_recommendation_tpu_torch.train.submission import submission_pipeline

quiet = lambda *_: None  # noqa: E731


@pytest.fixture(scope="module")
def movielens_raw(tmp_path_factory):
    """A tiny synthetic ml-1m-format dataset (5 users, 6 movies, 20 ratings),
    ``tests/test_etl.py``'s."""
    raw = tmp_path_factory.mktemp("ml_raw")
    users = [
        "1::F::1::10::48067", "2::M::56::16::70072", "3::M::25::15::55117",
        "4::M::45::7::02460", "5::M::25::20::55455",
    ]
    (raw / "users.dat").write_text("\n".join(users) + "\n")
    movies = [
        "1::Toy Story (1995)::Animation|Children's|Comedy",
        "2::Jumanji (1995)::Adventure|Children's|Fantasy",
        "3::Grumpier Old Men (1995)::Comedy|Romance",
        "4::Waiting to Exhale (1995)::Comedy|Drama",
        "5::Father of the Bride Part II (1995)::Comedy",
        "6::Heat (1995)::Action|Crime|Thriller",
    ]
    (raw / "movies.dat").write_text("\n".join(movies) + "\n")
    rng = np.random.default_rng(0)
    rows = []
    ts = 956700000
    for u in range(1, 6):
        for m in rng.choice(np.arange(1, 7), size=4, replace=False):
            ts += 100
            rows.append(f"{u}::{m}::5::{ts}")
    (raw / "ratings.dat").write_text("\n".join(rows) + "\n")
    return str(raw)


def _cfg():
    return Config(
        epochs=1, batch_size=2, num_neighbors=8, n_hop_neighbors=2,
        hidden_layer_size=8, encoder_layer_output_size=8,
        num_gnn_layers=2, num_linear_layers=2, k=4, candidate_pool_size=4,
        eval_every=10,
    )


class TestPrimitives:
    def test_encode_labels_sorted_codes(self):
        np.testing.assert_array_equal(encode_labels(np.array(["b", "a", "b", "c"])), [1, 0, 1, 2])

    def test_ids_and_maps_roundtrip(self):
        fwd, rev = create_ids_and_maps(np.array([30, 10, 20]))
        assert fwd == {0: 30, 1: 10, 2: 20}
        assert rev == {30: 0, 10: 1, 20: 2}

    def test_filter_unconnected(self):
        keep = filter_unconnected(np.array([1, 2, 3]), np.array([1, 3, 3]))
        np.testing.assert_array_equal(keep, [True, False, True])


class TestMovieLensPreprocess:
    def test_end_to_end(self, movielens_raw, tmp_path):
        art_dir = str(tmp_path / "derived")
        a = preprocess_movielens.preprocess(preprocessing_config, movielens_raw, art_dir)
        g = a.graph
        assert g.num_nodes[NODE_USER] == 5 and g.num_nodes[NODE_ITEM] == 6
        eu, ei = g.edges[EDGE_KEY]
        assert len(eu) == 20
        assert g.node_features[NODE_USER].shape == (5, 4)
        assert g.node_features[NODE_ITEM].shape[0] == 6
        for u in range(5):   # leave-last-2: one test and one val edge per user
            rows = eu == u
            assert a.test_mask[rows].sum() == 1
            assert a.val_mask[rows].sum() == 1
        b = load_artifacts(art_dir)
        np.testing.assert_array_equal(b.train_mask, a.train_mask)
        assert b.customer_id_map_forward["0"] == "1"

    def test_data_size_cap(self, movielens_raw, tmp_path):
        cfg = dataclasses.replace(preprocessing_config, data_size=10)
        a = preprocess_movielens.preprocess(cfg, movielens_raw, str(tmp_path / "derived"))
        assert len(a.graph.edges[EDGE_KEY][0]) == 10

    def test_pipeline_runs_on_artifacts(self, movielens_raw, tmp_path):
        art_dir = str(tmp_path / "derived")
        preprocess_movielens.preprocess(preprocessing_config, movielens_raw, art_dir)
        data, _ = create_link_pred_data_from_artifacts(art_dir, _cfg(), device="cpu")
        stats = run_pipeline(_cfg(), data, log_fn=quiet, device="cpu")
        assert np.isfinite(stats.loss)


def _graph_arrays(g):
    out = {}
    for t, x in g.node_features.items():
        out[f"x_{t}"] = x
    for t, x in g.node_features_float.items():
        out[f"xf_{t}"] = x
    for et, (s, d) in g.edges.items():
        out[f"e_{et.src}|{et.rel}|{et.dst}"] = (s, d)
    out["num_nodes"] = dict(g.num_nodes)
    return out


def _assert_same_artifacts(a, b):
    ga, gb = _graph_arrays(a.graph), _graph_arrays(b.graph)
    assert ga.keys() == gb.keys() and ga["num_nodes"] == gb["num_nodes"]
    for k in ga:
        if k == "num_nodes":
            continue
        for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (ga[k], gb[k]))):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for f in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert {str(k): str(v) for k, v in a.customer_id_map_forward.items()} == \
        {str(k): str(v) for k, v in b.customer_id_map_forward.items()}
    assert {str(k): str(v) for k, v in a.article_id_map_forward.items()} == \
        {str(k): str(v) for k, v in b.article_id_map_forward.items()}


@pytest.mark.parametrize("data_size", [None, 13])
def test_preprocess_equals_jax(movielens_raw, tmp_path, data_size):
    t = preprocess_movielens.preprocess(
        dataclasses.replace(preprocessing_config, data_size=data_size), movielens_raw,
        str(tmp_path / "port"))
    j = jpml.preprocess(dataclasses.replace(jpre_cfg, data_size=data_size), movielens_raw,
                        str(tmp_path / "jax"))
    _assert_same_artifacts(t, j)
    # the files on disk too, each loaded by its own package
    _assert_same_artifacts(load_artifacts(str(tmp_path / "port")),
                           jetl.load_artifacts(str(tmp_path / "jax")))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_artifacts_load_across_packages(movielens_raw, tmp_path, writer):
    """An artifact directory written by one package loads in the other, the
    optional popular-items and locations files included."""
    d = str(tmp_path / writer)
    if writer == "port":
        a = preprocess_movielens.preprocess(preprocessing_config, movielens_raw, d)
        a.popular_items = np.array([3, 1, 2], np.int64)
        a.location_for_user = np.array([0, 1, 0, 2, 1], np.int64)
        save_artifacts(d, a)
        b = jetl.load_artifacts(d)
    else:
        a = jpml.preprocess(jpre_cfg, movielens_raw, d)
        a.popular_items = np.array([3, 1, 2], np.int64)
        a.location_for_user = np.array([0, 1, 0, 2, 1], np.int64)
        jetl.save_artifacts(d, a)
        b = load_artifacts(d)
    _assert_same_artifacts(a, b)
    np.testing.assert_array_equal(b.popular_items, a.popular_items)
    np.testing.assert_array_equal(b.location_for_user, a.location_for_user)
    assert b.users_per_location == {0: [0, 2], 1: [1, 4], 2: [3]}


class TestSubmission:
    def _check_csv(self, out):
        lines = open(out).read().strip().split("\n")
        assert lines[0] == "customer_id,prediction"
        assert len(lines) == 6  # 5 users + header
        for line in lines[1:]:   # raw article ids (1..6), space-joined
            cid, preds = line.split(",")
            assert int(cid) in range(1, 6)
            for p in preds.split():
                assert int(p) in range(1, 7)

    def test_submission_csv(self, movielens_raw, tmp_path):
        art_dir = str(tmp_path / "derived")
        preprocess_movielens.preprocess(preprocessing_config, movielens_raw, art_dir)
        data, artifacts = create_link_pred_data_from_artifacts(art_dir, _cfg(), device="cpu")
        _, params, bn_state = run_pipeline(_cfg(), data, log_fn=quiet, return_state=True,
                                           device="cpu")
        out = submission_pipeline(
            _cfg(), data,
            {str(k): v for k, v in artifacts.customer_id_map_forward.items()},
            {str(k): v for k, v in artifacts.article_id_map_forward.items()},
            out_path=str(tmp_path / "submission.csv"),
            params_bn=(params, bn_state),
        )
        self._check_csv(out)

    def test_submission_from_checkpoint(self, movielens_raw, tmp_path):
        """Without ``params_bn`` the newest checkpoint is loaded, and gives
        the predictions of the params it holds."""
        art_dir = str(tmp_path / "derived")
        preprocess_movielens.preprocess(preprocessing_config, movielens_raw, art_dir)
        cfg = dataclasses.replace(_cfg(), save_model=True, save_every=1.0)
        data, artifacts = create_link_pred_data_from_artifacts(art_dir, cfg, device="cpu")
        model_dir = str(tmp_path / "model")
        _, params, bn_state = run_pipeline(cfg, data, model_dir=model_dir, log_fn=quiet,
                                           return_state=True, device="cpu")
        maps = (artifacts.customer_id_map_forward, artifacts.article_id_map_forward)
        a = submission_pipeline(cfg, data, *maps, model_dir=model_dir,
                                out_path=str(tmp_path / "from_ckpt.csv"))
        b = submission_pipeline(cfg, data, *maps, out_path=str(tmp_path / "given.csv"),
                                params_bn=(params, bn_state))
        self._check_csv(a)
        assert open(a).read() == open(b).read()
        with pytest.raises(FileNotFoundError):
            submission_pipeline(cfg, data, *maps, model_dir=str(tmp_path / "none"),
                                out_path=str(tmp_path / "x.csv"))


def test_lightgcn_data_from_hetero_equals_jax():
    t = lightgcn_data_from_hetero(random_hetero_graph(seed=6, num_users=30, num_items=20,
                                                      avg_degree=5), device="cpu")
    j = jlgd.lightgcn_data_from_hetero(jsynth.random_hetero_graph(seed=6, num_users=30,
                                                                  num_items=20, avg_degree=5))
    assert (t.num_users, t.num_items) == (j.num_users, j.num_items)
    for name in ("train_edges", "val_edges", "test_edges", "all_edges"):
        for x, y in zip(getattr(t, name), getattr(j, name)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for f in ("edge_user", "edge_item"):
        np.testing.assert_array_equal(getattr(t.test_set, f), np.asarray(getattr(j.test_set, f)))
    assert int(t.train_graph.num_edges) == int(j.train_graph.num_edges)
