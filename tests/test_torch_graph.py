"""Host data of the PyTorch port against the JAX package: graph arrays
(pads included), splits, padded user-item lists, synthetic generators and
the LightGCN data bundle must be identical for identical numpy inputs."""
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu.data import graph as jgraph
from laplace_gnn_recommendation_tpu.data import lightgcn_data as jdata
from laplace_gnn_recommendation_tpu.data import splitting as jsplit
from laplace_gnn_recommendation_tpu.data import synthetic as jsyn
from laplace_gnn_recommendation_tpu_torch.data import graph as tgraph
from laplace_gnn_recommendation_tpu_torch.data import lightgcn_data as tdata
from laplace_gnn_recommendation_tpu_torch.data import splitting as tsplit
from laplace_gnn_recommendation_tpu_torch.data import synthetic as tsyn

FIELDS = ("edge_user", "edge_item", "edge_w", "edge_user_im", "edge_item_im",
          "edge_w_im", "user_deg", "item_deg")


def _assert_graphs_equal(jg, tg):
    assert (jg.num_users, jg.num_items, jg.num_edges) == (tg.num_users, tg.num_items, tg.num_edges)
    for f in FIELDS:
        a = np.asarray(getattr(jg, f))
        b = getattr(tg, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("U,I,E,pad", [(40, 30, 301, 128), (7, 5, 19, 8), (50, 60, 256, 128)])
def test_from_edges_matches_jax_including_pads(U, I, E, pad):
    rng = np.random.default_rng(U + E)
    eu, ei = rng.integers(0, U, E), rng.integers(0, I, E)
    jg = jgraph.BipartiteGraph.from_edges(eu, ei, U, I, pad_multiple=pad)
    tg = tgraph.BipartiteGraph.from_edges(eu, ei, U, I, pad_multiple=pad, device="cpu")
    _assert_graphs_equal(jg, tg)
    e = tg.num_edges
    if tg.num_edges_padded > e:
        # pads repeat the last real ids and carry w = 0
        assert (tg.edge_user[e:] == tg.edge_user[e - 1]).all()
        assert (tg.edge_item_im[e:] == tg.edge_item_im[e - 1]).all()
        assert (tg.edge_w[e:] == 0).all() and (tg.edge_w_im[e:] == 0).all()
    for a, b in zip(jg.host_arrays(), tg.host_arrays()):
        np.testing.assert_array_equal(a, b)


def test_empty_graph_matches_jax():
    empty = np.zeros(0, np.int64)
    jg = jgraph.BipartiteGraph.from_edges(empty, empty, 4, 3)
    tg = tgraph.BipartiteGraph.from_edges(empty, empty, 4, 3, device="cpu")
    _assert_graphs_equal(jg, tg)
    assert tg.num_edges == 0 and tg.num_edges_padded == 128


def test_host_csr_matches_jax():
    rng = np.random.default_rng(3)
    s, d = rng.integers(0, 20, 200), rng.integers(0, 15, 200)
    a = jgraph.HostCSR.from_edges(s, d, 20, 15)
    b = tgraph.HostCSR.from_edges(s, d, 20, 15)
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.degrees, b.degrees)


@pytest.mark.parametrize("pad_to", [None, 3])
def test_padded_user_items_matches_jax(pad_to):
    rng = np.random.default_rng(5)
    eu, ei = rng.integers(0, 30, 400), rng.integers(0, 50, 400)
    users = np.concatenate([np.arange(35), [2, 2, 0]]).astype(np.int32)  # absent + repeated users
    a = jdata.padded_user_items(users, eu, ei, pad_to)
    b = tdata.padded_user_items(users, eu, ei, pad_to)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,seed", [(1000, 1), (17, 4), (0, 1)])
def test_random_edge_split_matches_jax(n, seed):
    for a, b in zip(jsplit.random_edge_split(n, seed), tsplit.random_edge_split(n, seed)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_generators_match_jax():
    for a, b in zip(jsyn.random_bipartite_edges(3, 200, 90, 7.5, 0.8),
                    tsyn.random_bipartite_edges(3, 200, 90, 7.5, 0.8)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jsyn.movielens_like_edges(0, 0.02), tsyn.movielens_like_edges(0, 0.02)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jsyn.latent_bipartite_edges(2, 100, 80, 6.0, num_clusters=4),
                    tsyn.latent_bipartite_edges(2, 100, 80, 6.0, num_clusters=4)):
        np.testing.assert_array_equal(a, b)


def test_create_lightgcn_data_matches_jax():
    eu, ei = tsyn.random_bipartite_edges(0, 120, 70, 9.0, 0.8)
    a = jdata.create_lightgcn_data(eu, ei, 120, 70)
    b = tdata.create_lightgcn_data(eu, ei, 120, 70, device="cpu")
    for name in ("train", "val", "test"):
        _assert_graphs_equal(getattr(a, f"{name}_graph"), getattr(b, f"{name}_graph"))
        for x, y in zip(getattr(a, f"{name}_edges"), getattr(b, f"{name}_edges")):
            np.testing.assert_array_equal(x, y)
    for name in ("val_set", "test_set"):
        sa, sb = getattr(a, name), getattr(b, name)
        for f in ("users", "gt_items", "gt_count", "exclude_items", "exclude_count",
                  "edge_user", "edge_item"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f), err_msg=f"{name}.{f}")
    assert b.train_graph.edge_user.device == torch.device("cpu")
