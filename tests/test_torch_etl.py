"""ETL in the PyTorch port: the ports of ``tests/test_etl.py``'s
``TestPrimitives``, ``TestMovieLensPreprocess``, ``TestSubmission``,
``TestFashionPreprocess``, ``TestPandasGraphBuilder`` and ``TestSweepYaml``;
``preprocess`` (MovieLens, and H&M from parquet files written here) on the
same raw files gives the JAX package's artifacts array for array; an
artifact directory written by either package loads in the other;
``submission_pipeline`` from a checkpoint; ``lightgcn_data_from_hetero``
against the JAX function; ``download.py`` with ``urlretrieve`` copying
local files (no network). Everything here is exact (integer arrays, id
maps, the CLIP vectors read back): no tolerance. Tests that need pandas and
pyarrow skip where they are missing."""
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


def _in_jax_column_order(a, movielens_raw):
    """The port's artifacts with the item feature columns in the order the
    JAX package took in this process: its genre columns follow a set's
    order, which changes with the process's string hashing; the port's
    follow the file."""
    movies = os.path.join(movielens_raw, "movies.dat")
    names = list(preprocess_movielens.parse_movies(movies))
    perm = [names.index(n) - 1 for n in list(jpml.parse_movies(movies))[1:]]
    a.graph.node_features[NODE_ITEM] = a.graph.node_features[NODE_ITEM][:, perm]
    return a


@pytest.mark.parametrize("data_size", [None, 13])
def test_preprocess_equals_jax(movielens_raw, tmp_path, data_size):
    t = preprocess_movielens.preprocess(
        dataclasses.replace(preprocessing_config, data_size=data_size), movielens_raw,
        str(tmp_path / "port"))
    j = jpml.preprocess(dataclasses.replace(jpre_cfg, data_size=data_size), movielens_raw,
                        str(tmp_path / "jax"))
    _assert_same_artifacts(_in_jax_column_order(t, movielens_raw), j)
    # the files on disk too, each loaded by its own package
    _assert_same_artifacts(_in_jax_column_order(load_artifacts(str(tmp_path / "port")),
                                                movielens_raw),
                           jetl.load_artifacts(str(tmp_path / "jax")))


def test_genre_columns_in_file_order(movielens_raw):
    """The genre columns come in the file's order of first appearance, which
    no process's string hashing changes (a set's order made a seed's
    PinSAGE training differ from one process to the next)."""
    cols = preprocess_movielens.parse_movies(os.path.join(movielens_raw, "movies.dat"))
    assert list(cols) == ["article_id", "year", "Animation", "Children's", "Comedy",
                          "Adventure", "Fantasy", "Romance", "Drama", "Action", "Crime",
                          "Thriller"]
    np.testing.assert_array_equal(cols["Comedy"], [1, 0, 1, 1, 1, 0])


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


# ---- H&M fashion preprocessing, the pandas builder, the sweep artifact --------

@pytest.fixture(scope="module")
def fashion_raw(tmp_path_factory):
    """``tests/test_etl.py``'s H&M-format parquet tables (6 customers, 8
    articles, 40 raw transactions over two months)."""
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    raw = tmp_path_factory.mktemp("fashion_raw")
    rng = np.random.default_rng(1)
    customers = pd.DataFrame({
        "customer_id": [f"c{i}" for i in range(6)],
        "postal_code": ["11", "11", "22", "22", "33", "33"],
        "FN": [1.0, 0, 1.0, 0, 1.0, 0], "age": [20, 30, 40, 20, 30, 40],
        "club_member_status": ["ACTIVE"] * 6, "fashion_news_frequency": ["NONE"] * 6,
        "Active": [1.0] * 6,
    })
    customers.to_parquet(raw / "customers.parquet")
    articles = pd.DataFrame({
        "article_id": [100 + i for i in range(8)],
        "product_code": [1, 1, 2, 2, 3, 3, 4, 4],
        "product_type_no": [7, 7, 8, 8, 9, 9, 7, 7],
        "graphical_appearance_no": [5] * 8,
        "colour_group_code": [1, 2, 1, 2, 3, 3, 1, 2],
    })
    articles.to_parquet(raw / "articles.parquet")
    n_tx = 40
    pd.DataFrame({
        "customer_id": rng.choice(customers["customer_id"], n_tx),
        "article_id": rng.choice(articles["article_id"], n_tx),
        "price": rng.uniform(1, 10, n_tx),
        "t_dat": pd.to_datetime("2020-01-01") + pd.to_timedelta(np.arange(n_tx), unit="D"),
    }).to_parquet(raw / "transactions_train.parquet")
    # CLIP vectors for 7 of the 8 articles (the eighth stays a zero row)
    from laplace_gnn_recommendation_tpu_torch.data.clip_embed import write_embeddings_npz

    for name, dim in (("image_embeddings.npz", 6), ("text_embeddings.npz", 5)):
        write_embeddings_npz(str(raw / name), [100 + i for i in range(7)],
                             rng.normal(size=(7, dim)).astype(np.float32))
    return str(raw)


def _assert_same_fashion(a, b):
    _assert_same_artifacts(a, b)
    np.testing.assert_array_equal(a.popular_items, b.popular_items)
    np.testing.assert_array_equal(a.location_for_user, b.location_for_user)


@pytest.mark.parametrize("extra,data_size,embeddings", [(True, None, False), (False, 25, True),
                                                        (True, None, True)])
def test_fashion_preprocess_equals_jax(fashion_raw, tmp_path, extra, data_size, embeddings):
    from laplace_gnn_recommendation_tpu.data import preprocess_fashion as jpf
    from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY_EXTRA, NODE_EXTRA
    from laplace_gnn_recommendation_tpu_torch.data import preprocess_fashion

    kw = dict(data_size=data_size, load_image_embedding=embeddings,
              load_text_embedding=embeddings)
    t = preprocess_fashion.preprocess(dataclasses.replace(preprocessing_config, **kw),
                                      fashion_raw, str(tmp_path / "port"),
                                      include_extra_nodes=extra)
    j = jpf.preprocess(dataclasses.replace(jpre_cfg, **kw), fashion_raw, str(tmp_path / "jax"),
                       include_extra_nodes=extra)
    _assert_same_fashion(t, j)
    _assert_same_fashion(load_artifacts(str(tmp_path / "port")),
                         jetl.load_artifacts(str(tmp_path / "jax")))
    g = t.graph
    assert (NODE_EXTRA in g.num_nodes) == extra and (EDGE_KEY_EXTRA in g.edges) == extra
    eu, ei = g.edges[EDGE_KEY]
    assert len(set(zip(eu.tolist(), ei.tolist()))) == len(eu)   # deduplicated
    if embeddings:
        assert g.node_features_float[NODE_ITEM].shape == (g.num_nodes[NODE_ITEM], 11)


def test_fashion_split_transactions_equals_jax(fashion_raw, tmp_path):
    """``split_transactions`` on the raw table, and ``preprocess`` reading a
    ``transactions_splitted.parquet`` when one is there."""
    import pandas as pd

    from laplace_gnn_recommendation_tpu.data import preprocess_fashion as jpf
    from laplace_gnn_recommendation_tpu_torch.data import preprocess_fashion

    tx = pd.read_parquet(os.path.join(fashion_raw, "transactions_train.parquet"))
    t, j = preprocess_fashion.split_transactions(tx), jpf.split_transactions(tx)
    pd.testing.assert_frame_equal(t, j)
    raw = tmp_path / "raw"
    raw.mkdir()
    for name in ("customers.parquet", "articles.parquet"):
        (raw / name).write_bytes(open(os.path.join(fashion_raw, name), "rb").read())
    t.to_parquet(raw / "transactions_splitted.parquet")
    a = preprocess_fashion.preprocess(preprocessing_config, str(raw), str(tmp_path / "port"))
    b = jpf.preprocess(jpre_cfg, fashion_raw, str(tmp_path / "jax"))
    _assert_same_fashion(a, b)


def test_cli_preprocess_fashion(fashion_raw, tmp_path, monkeypatch):
    """``--type preprocess_fashion`` runs (no longer refused) and writes the
    JAX package's artifacts."""
    import sys

    from laplace_gnn_recommendation_tpu.data import preprocess_fashion as jpf
    from laplace_gnn_recommendation_tpu_torch import cli

    out = str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["cli", "--type", "preprocess_fashion", "--raw_dir",
                                      fashion_raw, "--artifact_dir", out])
    cli.run()
    _assert_same_fashion(load_artifacts(out),
                         jpf.preprocess(jpre_cfg, fashion_raw, str(tmp_path / "jax")))


def _frames():
    import pandas as pd

    users = pd.DataFrame({"user_id": ["XYZZY", "FOO", "BAR"], "country": ["US", "CN", "CN"],
                          "age": [25, 24, 23]})
    games = pd.DataFrame({"game_id": [1, 2], "title": ["Minecraft", "Tetris"],
                          "score": [0.9, 0.7]})
    plays = pd.DataFrame({"user_id": ["XYZZY", "FOO", "FOO", "BAR"], "game_id": [1, 1, 2, 2]})
    return users, games, plays


def test_pandas_graph_builder_equals_jax():
    pytest.importorskip("pandas")
    from laplace_gnn_recommendation_tpu.data.pandas_builder import (
        PandasGraphBuilder as JBuilder,
    )
    from laplace_gnn_recommendation_tpu_torch.data.pandas_builder import PandasGraphBuilder
    from laplace_gnn_recommendation_tpu_torch.types import EdgeType

    users, games, plays = _frames()
    built = []
    for cls in (PandasGraphBuilder, JBuilder):
        b = cls()
        b.add_entities(users, "user_id", "customer", feature_cols=["country", "age"])
        b.add_entities(games, "game_id", "article", feature_cols=["title"],
                       float_feature_cols=["score"])
        b.add_entities(users[["user_id"]].rename(columns={"user_id": "uid"}), "uid", "extra")
        b.add_binary_relations(plays, "user_id", "game_id", EDGE_KEY.rel)
        built.append(b.build())
    (g, maps), (jg, jmaps) = built
    ga, gb = _graph_arrays(g), _graph_arrays(jg)
    assert ga.keys() == gb.keys() and ga["num_nodes"] == gb["num_nodes"] == {
        "customer": 3, "article": 2, "extra": 3}
    for k in ga:
        if k != "num_nodes":
            for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (ga[k], gb[k]))):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert maps == jmaps
    s, d = g.edges[EdgeType("customer", EDGE_KEY.rel, "article")]
    np.testing.assert_array_equal(np.sort(d[s == maps["customer"]["FOO"]]), [0, 1])
    assert g.node_features["customer"].shape == (3, 2)
    assert g.node_features_float["article"].shape == (2, 1)
    # it drops straight into the ranking stack
    from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import create_link_pred_data

    data = create_link_pred_data(g, Config(batch_size=2, candidate_pool_size=2, k=2),
                                 device="cpu")
    assert data.num_users == 3


def test_pandas_graph_builder_rejects_duplicate_keys():
    pd = pytest.importorskip("pandas")
    from laplace_gnn_recommendation_tpu_torch.data.pandas_builder import PandasGraphBuilder

    with pytest.raises(ValueError, match="duplicate primary keys"):
        PandasGraphBuilder().add_entities(pd.DataFrame({"id": [1, 1]}), "id", "customer")


# ---- data/download.py, with no network: urlretrieve copies local files --------

def test_download_movielens_from_a_local_zip(movielens_raw, tmp_path, monkeypatch):
    import shutil
    import zipfile

    from laplace_gnn_recommendation_tpu_torch.data import download

    src = tmp_path / "ml-1m.zip"
    with zipfile.ZipFile(src, "w") as z:
        for name in ("users.dat", "movies.dat", "ratings.dat"):
            z.write(os.path.join(movielens_raw, name), f"ml-1m/{name}")
    calls = []

    def fake_urlretrieve(url, dest):
        calls.append(url)
        shutil.copy(src, dest)

    monkeypatch.setattr(download.urllib.request, "urlretrieve", fake_urlretrieve)
    raw = str(tmp_path / "raw")
    download.download_movielens(raw)
    assert calls == [download.MOVIELENS_URL]
    assert sorted(os.listdir(raw)) == ["movies.dat", "ratings.dat", "users.dat"]
    for name in os.listdir(raw):
        assert open(os.path.join(raw, name)).read() == \
            open(os.path.join(movielens_raw, name)).read()
    download.download_movielens(raw)     # already there: nothing is fetched
    assert len(calls) == 1
    a = preprocess_movielens.preprocess(preprocessing_config, raw, str(tmp_path / "derived"))
    assert a.graph.num_nodes[NODE_USER] == 5


def test_download_fashion_from_a_local_host(tmp_path, monkeypatch):
    import shutil

    from laplace_gnn_recommendation_tpu_torch.data import download

    monkeypatch.delenv("DATA_HOST_URL", raising=False)
    with pytest.raises(RuntimeError, match="DATA_HOST_URL"):
        download.download_fashion(str(tmp_path / "raw"))
    host = tmp_path / "host"
    host.mkdir()
    for name in ("customers.parquet", "articles.parquet", "transactions_splitted.parquet"):
        (host / name).write_bytes(name.encode())
    calls = []

    def fake_urlretrieve(url, dest):
        calls.append(url)
        shutil.copy(url.replace("file://", ""), dest)

    monkeypatch.setattr(download.urllib.request, "urlretrieve", fake_urlretrieve)
    monkeypatch.setenv("DATA_HOST_URL", f"file://{host}")
    download.download_fashion(str(tmp_path / "raw"))
    assert len(calls) == 3
    for name in os.listdir(host):
        assert (tmp_path / "raw" / name).read_bytes() == name.encode()
    download.download_fashion(str(tmp_path / "raw"))
    assert len(calls) == 3


def test_sweep_yaml_equals_jax(tmp_path):
    """``sweep.yaml`` (the reference's wandb sweep) read into a search space
    as the JAX package reads it; ranges, categorical values, a missing file."""
    from laplace_gnn_recommendation_tpu.train import hpo as jhpo
    from laplace_gnn_recommendation_tpu_torch.train import hpo

    space = hpo.load_sweep_yaml("sweep.yaml")
    assert space == jhpo.load_sweep_yaml("sweep.yaml")
    assert space["hidden_layer_size"] == [32, 64, 128, 256, 512]
    assert space["learning_rate"] == [1e-2, 1e-3, 1e-4, 1e-5]
    assert hpo.resolve_search_space("sweep.yaml") == space
    assert hpo.resolve_search_space(str(tmp_path / "none.yaml")) == hpo.SEARCH_SPACE
    y = tmp_path / "s.yaml"
    y.write_text("method: random\nparameters:\n  depth:\n    min: 2\n    max: 4\n"
                 "  act:\n    values: [relu, 'gelu', 0.5]\nother: 1\n")
    assert hpo.load_sweep_yaml(str(y)) == jhpo.load_sweep_yaml(str(y)) == {
        "depth": [2, 3, 4], "act": ["relu", "gelu", 0.5]}
    for v in ("3", "2.5", "'x'", " y "):
        assert hpo._parse_sweep_value(v) == jhpo._parse_sweep_value(v)
