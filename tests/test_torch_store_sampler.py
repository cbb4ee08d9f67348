"""The graph-store layer in the PyTorch port against the JAX package's
``data/graph_store.py`` and ``data/store_sampler.py``: the Cypher strings
and the bulk-import CSVs byte for byte, the in-memory store's rows (held
by relationship, ``SubgraphRows``, and decoded whole), and the
store-backed sampler's batches field by field (with the store's query count)
on the cases of ``tests/test_store_sampler.py`` — the dummy graph at
saturation, the eval path with matchers, the split filter, the extra edge
type, randomized sampling and the 10k-node graph; then
``create_samplers(graph_store=)`` and ``run_pipeline(graph_store=)``, whose
epoch loss from one checkpoint matches the JAX pipeline's within
``tests/test_torch_encdec.py``'s second-step bound (rel 1e-4). Host arrays
are compared exactly."""
import os
import shutil

import numpy as np
import pytest

from laplace_gnn_recommendation_tpu.configs import Config as JConfig
from laplace_gnn_recommendation_tpu.data import graph_store as jgs
from laplace_gnn_recommendation_tpu.data import link_pred_data as jlpd
from laplace_gnn_recommendation_tpu.data import store_sampler as jss
from laplace_gnn_recommendation_tpu.data import synthetic as jsynth
from laplace_gnn_recommendation_tpu.data.graph import HostCSR as JHostCSR
from laplace_gnn_recommendation_tpu.data.matchers import Matcher as JMatcher
from laplace_gnn_recommendation_tpu.train import encdec_pipeline as jpipe
from laplace_gnn_recommendation_tpu_torch.configs import Config
from laplace_gnn_recommendation_tpu_torch.constants import (
    EDGE_KEY,
    EDGE_KEY_EXTRA,
    NODE_EXTRA,
    NODE_ITEM,
    NODE_USER,
)
from laplace_gnn_recommendation_tpu_torch.data import graph_store as gs
from laplace_gnn_recommendation_tpu_torch.data import link_pred_data as lpd
from laplace_gnn_recommendation_tpu_torch.data.graph import HeteroGraph, HostCSR
from laplace_gnn_recommendation_tpu_torch.data.matchers import Matcher
from laplace_gnn_recommendation_tpu_torch.data.sampler import SubgraphSampler
from laplace_gnn_recommendation_tpu_torch.data.store_sampler import (
    GraphStoreSampler,
    InMemoryGraphStore,
)
from laplace_gnn_recommendation_tpu_torch.data.synthetic import (
    manual_dummy_graph,
    random_hetero_graph,
)
from laplace_gnn_recommendation_tpu_torch.train import encdec_pipeline as pipe

LABELS = {NODE_USER: NODE_USER, NODE_ITEM: NODE_ITEM, NODE_EXTRA: NODE_EXTRA}
FIELDS = ("user_ids", "item_ids", "user_mask", "item_mask", "edge_src", "edge_dst",
          "edge_mask", "label_src", "label_dst", "label", "label_mask", "label_item_global",
          "seed_users", "seed_slots", "gt_items", "gt_count")
quiet = lambda *_: None  # noqa: E731


def _store_args(graph, split=None):
    """A store's arguments over a graph of either package (keyed by its own
    ``EdgeType``): ``buys`` edges split as ``split`` (all TRAIN by default),
    ``has_color`` edges unsuffixed."""
    edges, edge_split = {}, {}
    for key, (s, d) in graph.edges.items():
        if key.as_tuple() == EDGE_KEY.as_tuple():
            edges[key] = (s, d)
            edge_split[key] = np.zeros(len(s), np.int64) if split is None else split
        elif key.as_tuple() == EDGE_KEY_EXTRA.as_tuple():
            edges[key], edge_split[key] = (s, d), None
    return LABELS, edges, edge_split


def _csrs(graph, csr=HostCSR):
    s, d = graph.edges[EDGE_KEY]
    nu, ni = graph.num_nodes[NODE_USER], graph.num_nodes[NODE_ITEM]
    return csr.from_edges(s, d, nu, ni), csr.from_edges(d, s, ni, nu)


def _pair(graph, cfg_kw, split=None, split_type="train", matchers=None, **kw):
    """The port's and the JAX package's store-backed samplers over one graph."""
    t = GraphStoreSampler(Config(**cfg_kw), InMemoryGraphStore(*_store_args(graph, split)),
                          *_csrs(graph), split_type=split_type,
                          matchers=matchers and matchers[0], **kw)
    j = jss.GraphStoreSampler(JConfig(**cfg_kw), jss.InMemoryGraphStore(*_store_args(graph, split)),
                              *_csrs(graph, JHostCSR), split_type=split_type,
                              matchers=matchers and matchers[1], **kw)
    return t, j


def _assert_same_batch(t, j):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(t, f)), np.asarray(getattr(j, f)),
                                      err_msg=f)


def _edge_pairs(batch):
    m = np.asarray(batch.edge_mask)
    src = np.asarray(batch.user_ids)[np.asarray(batch.edge_src)[m]]
    dst = np.asarray(batch.item_ids)[np.asarray(batch.edge_dst)[m]]
    return sorted(zip(src.tolist(), dst.tolist()))


def _matchers(table):
    class T(Matcher):
        def get_matches(self, user_id):
            return np.asarray(table[int(user_id)], np.int64)

    class J(JMatcher):
        def get_matches(self, user_id):
            return np.asarray(table[int(user_id)], np.int64)

    return [T()], [J()]


SATURATING = dict(batch_size=3, num_neighbors=100, n_hop_neighbors=6, k=4,
                  candidate_pool_size=4)


# ---- Cypher builders, row decode, bulk import -------------------------------

@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("no_return", [False, True])
def test_cypher_strings_equal_jax(split, no_return):
    assert gs.split_relationship_filter(split) == jgs.split_relationship_filter(split)
    for args in ((7, 3, NODE_USER, split, 0, no_return), (12, 1, NODE_ITEM, split, 1, no_return)):
        assert gs.query_n_neighbors(*args) == jgs.query_n_neighbors(*args)
    assert gs.query_node(5, NODE_USER, no_return) == jgs.query_node(5, NODE_USER, no_return)
    assert gs.query_all_nodes(NODE_ITEM) == jgs.query_all_nodes(NODE_ITEM)
    assert gs.bulk_import_command("out", "db") == jgs.bulk_import_command("out", "db")


def test_decode_subgraph_rows_equal_jax():
    rows = [[NODE_USER, "buys_TRAIN", NODE_ITEM, "3", "7"],
            [NODE_USER, "buys_VAL", NODE_ITEM, 1, 2],
            [NODE_ITEM, "has_color", NODE_EXTRA, 4, 0],
            [NODE_USER, "buys_TEST", NODE_ITEM, 5, 9]]
    t, j = gs.decode_subgraph_rows(rows), jgs.decode_subgraph_rows(rows)
    assert [k.as_tuple() for k in t] == [k.as_tuple() for k in j]
    for k, jk in zip(t, j):
        assert t[k].dtype == j[jk].dtype
        np.testing.assert_array_equal(t[k], j[jk])
    assert gs.decode_subgraph_rows([]) == jgs.decode_subgraph_rows([]) == {}


def test_bulk_import_csvs_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    uf, af = rng.integers(0, 9, (7, 2)), rng.integers(0, 5, (6, 3))
    eu, ei = rng.integers(0, 7, 30), rng.integers(0, 6, 30)
    split = rng.integers(0, 3, 30)
    args = (uf, ["age", "zip"], af, ["colour", "type", "year"], eu, ei,
            split == 0, split == 1, split == 2)
    tp = gs.export_bulk_import_csvs(str(tmp_path / "port"), *args)
    jp = jgs.export_bulk_import_csvs(str(tmp_path / "jax"), *args)
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_database_needs_the_driver():
    try:
        import neo4j  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="neo4j driver not installed"):
            gs.Database("bolt://localhost:7687", "u", "p")
    else:
        pytest.skip("the neo4j driver is installed: construction would connect")


# ---- the in-memory store ----------------------------------------------------

@pytest.mark.parametrize("split_type", ["train", "val", "test"])
def test_store_rows_equal_jax(split_type):
    g = random_hetero_graph(seed=3, num_users=10, num_items=12, avg_degree=3, num_extra=4)
    split = np.random.default_rng(2).integers(0, 3, len(g.edges[EDGE_KEY][0]))
    t, j = InMemoryGraphStore(*_store_args(g, split)), jss.InMemoryGraphStore(
        *_store_args(g, split))
    for seed_user in range(10):
        q = gs.query_n_neighbors(seed_user, 2, NODE_USER, split_type, 1, True)
        rows, jrows = t.run_match(q)[0][0], j.run_match(q)[0][0]
        assert isinstance(rows, gs.SubgraphRows) and list(rows) == jrows
        assert len(rows) == len(jrows)
        # the blocks decode to the arrays the rows decode to, the JAX package's
        got, by_row, want = (gs.decode_subgraph_rows(rows), gs.decode_subgraph_rows(list(rows)),
                             jgs.decode_subgraph_rows(jrows))
        assert [k.as_tuple() for k in got] == [k.as_tuple() for k in by_row] == [
            k.as_tuple() for k in want]
        for k, jk in zip(got, want):
            np.testing.assert_array_equal(got[k], by_row[k])
            np.testing.assert_array_equal(got[k], want[jk])
    assert t.queries_served == j.queries_served == 10
    with pytest.raises(ValueError, match="unsupported query"):
        t.run_match("MATCH (n) RETURN n")


# ---- the store-backed sampler against the JAX package's -----------------------

def test_train_parity_at_saturation():
    g = manual_dummy_graph()
    t, j = _pair(g, SATURATING, train=True, randomization=False, seed=0)
    seeds = np.array([0, 1, 2])
    bt, bj = t.sample_batch(seeds), j.sample_batch(seeds)
    _assert_same_batch(bt, bj)
    assert t.store.queries_served == j.store.queries_served == 3
    # and the port's in-process BFS gives the same subgraph at saturation
    mem = SubgraphSampler(Config(**SATURATING), *_csrs(g), train=True, randomization=False,
                          seed=0, use_native=False).sample_batch(seeds)
    assert _edge_pairs(mem) == _edge_pairs(bt)


def test_eval_parity_with_matchers():
    g = manual_dummy_graph()
    m = _matchers({0: [3, 4], 1: [0, 5], 2: [0, 1, 4]})
    t, j = _pair(g, SATURATING, split_type="test", matchers=m, train=False,
                 randomization=False, seed=0)
    seeds = np.array([0, 1, 2])
    _assert_same_batch(t.sample_batch(seeds), j.sample_batch(seeds))
    assert t.store.queries_served == j.store.queries_served == 3


@pytest.mark.parametrize("split_type", ["train", "val"])
def test_split_filter(split_type):
    """A val-only edge is a hop edge for seed 0 under the val filter and
    absent under the train one, in both packages."""
    g = manual_dummy_graph()
    s, d = g.edges[EDGE_KEY]
    split = np.zeros(len(s), np.int64)
    split[int(np.flatnonzero((s == 1) & (d == 4))[0])] = 1
    cfg = dict(batch_size=1, num_neighbors=100, n_hop_neighbors=3, k=4, candidate_pool_size=4)
    t, j = _pair(g, cfg, split=split, split_type=split_type, train=True, randomization=False,
                 seed=0)
    bt, bj = t.sample_batch(np.array([0])), j.sample_batch(np.array([0]))
    _assert_same_batch(bt, bj)
    assert ((1, 4) in _edge_pairs(bt)) == (split_type == "val")


def test_other_edge_types_ride_along():
    g = random_hetero_graph(seed=3, num_users=10, num_items=12, avg_degree=3, num_extra=4)
    cfg = dict(batch_size=2, num_neighbors=100, n_hop_neighbors=2, k=4, candidate_pool_size=4)
    t = GraphStoreSampler(Config(**cfg, other_edge_types=[EDGE_KEY_EXTRA]),
                          InMemoryGraphStore(*_store_args(g)), *_csrs(g), train=True,
                          randomization=False, seed=0)
    jextra = jss.EdgeType(*EDGE_KEY_EXTRA.as_tuple())
    j = jss.GraphStoreSampler(JConfig(**cfg, other_edge_types=[jextra]),
                              jss.InMemoryGraphStore(*_store_args(g)), *_csrs(g, JHostCSR),
                              train=True, randomization=False, seed=0)
    _assert_same_batch(t.sample_batch(np.array([0, 1])), j.sample_batch(np.array([0, 1])))
    extra = t.last_other_edges[EDGE_KEY_EXTRA]
    np.testing.assert_array_equal(extra, j.last_other_edges[jextra])
    assert extra.shape[0] == 2 and extra.shape[1] > 0
    es, ed = g.edges[EDGE_KEY_EXTRA]
    assert set(zip(extra[0].tolist(), extra[1].tolist())) <= set(zip(es.tolist(), ed.tolist()))


def test_randomized_batches_equal_jax():
    """One seed draws the JAX package's batches in randomized mode too (the
    store path samples on numpy, as the JAX package's does)."""
    g = random_hetero_graph(seed=5, num_users=20, num_items=25, avg_degree=4)
    cfg = dict(batch_size=4, num_neighbors=8, n_hop_neighbors=2, k=4, candidate_pool_size=4)
    t, j = _pair(g, cfg, train=True, randomization=True, seed=7)
    for seeds in (np.arange(4), np.array([9, 3, 17, 3])):
        _assert_same_batch(t.sample_batch(seeds), j.sample_batch(seeds))


def test_parity_at_10k_nodes():
    rng = np.random.default_rng(11)
    n_clusters, upc, ipc = 500, 20, 10     # 10k users, 5k items
    nu, ni = n_clusters * upc, n_clusters * ipc
    u = np.repeat(np.arange(nu), 3)
    i = rng.integers(0, ipc, len(u)) + (u // upc) * ipc
    s, d = np.unique(np.stack([u, i]), axis=1)
    g = HeteroGraph(node_features={NODE_USER: np.zeros((nu, 1), np.int32),
                                   NODE_ITEM: np.zeros((ni, 1), np.int32)},
                    edges={EDGE_KEY: (s, d)}, num_nodes={NODE_USER: nu, NODE_ITEM: ni})
    cfg = dict(SATURATING, batch_size=8)
    t, j = _pair(g, cfg, train=True, randomization=False, seed=0)
    seeds = rng.integers(0, nu, 8)
    bt = t.sample_batch(seeds)
    _assert_same_batch(bt, j.sample_batch(seeds))
    assert t.store.queries_served == j.store.queries_served == 8
    mem = SubgraphSampler(Config(**cfg), *_csrs(g), train=True, randomization=False, seed=0,
                          use_native=False).sample_batch(seeds)
    assert _edge_pairs(mem) == _edge_pairs(bt)


def test_clone_keeps_the_store():
    g = manual_dummy_graph()
    t, _ = _pair(g, SATURATING, train=True, randomization=False, seed=0)
    c = t.clone(3)
    assert isinstance(c, GraphStoreSampler) and c.store is t.store
    c.sample_batch(np.array([0]))
    assert t.store.queries_served == 1


# ---- the pipeline hooks -----------------------------------------------------

PIPE = dict(epochs=1, batch_size=30, num_neighbors=16, n_hop_neighbors=2, k=4,
            candidate_pool_size=4, eval_every=1, hidden_layer_size=8,
            encoder_layer_output_size=8, p_dropout_features=0.0, batch_norm=False,
            save_model=True, save_every=1.0, seed=2)
GRAPH = dict(seed=8, num_users=60, num_items=18, avg_degree=4)


def test_create_samplers_with_store():
    """A store gives store-backed samplers on every split, with the JAX
    package's (unprobed) budgets."""
    cfg_kw = dict(PIPE, budget_probe=4)
    data = lpd.create_link_pred_data(random_hetero_graph(**GRAPH), Config(**cfg_kw),
                                     device="cpu")
    jdata = jlpd.create_link_pred_data(jsynth.random_hetero_graph(**GRAPH), JConfig(**cfg_kw))
    store = InMemoryGraphStore(*_store_args(random_hetero_graph(**GRAPH)))
    jstore = jss.InMemoryGraphStore(*_store_args(jsynth.random_hetero_graph(**GRAPH)))
    ts = lpd.create_samplers(Config(**cfg_kw), data, graph_store=store)
    js = jlpd.create_samplers(JConfig(**cfg_kw), jdata, graph_store=jstore)
    for t, j, split in zip(ts, js, ("train", "val", "test")):
        assert isinstance(t, GraphStoreSampler) and t.split_type == split and t.store is store
        assert vars(t.budgets) == vars(j.budgets)
    probed = lpd.create_samplers(Config(**cfg_kw), data)[0]
    assert not isinstance(probed, GraphStoreSampler)
    assert store.queries_served == 0   # no probe went to the store


def test_run_pipeline_with_store_matches_jax(tmp_path):
    """One epoch from one checkpoint (written by the JAX pipeline) through the
    store-backed sampler in both packages: the same batches, the loss within
    rel 1e-4; both stores answer the same number of queries."""
    jcfg = JConfig(**PIPE)
    jdata = jlpd.create_link_pred_data(jsynth.random_hetero_graph(**GRAPH), jcfg)
    first = str(tmp_path / "first")
    jpipe.run_pipeline(jcfg, jdata, model_dir=first, log_fn=quiet, randomization=False,
                       graph_store=jss.InMemoryGraphStore(
                           *_store_args(jsynth.random_hetero_graph(**GRAPH))))
    for d in ("jax", "port"):
        shutil.copytree(first, str(tmp_path / d))
    jstore = jss.InMemoryGraphStore(*_store_args(jsynth.random_hetero_graph(**GRAPH)))
    jstats = jpipe.run_pipeline(JConfig(**dict(PIPE, epochs=2)), jdata,
                                model_dir=str(tmp_path / "jax"), log_fn=quiet,
                                randomization=False, resume=True, graph_store=jstore)
    data = lpd.create_link_pred_data(random_hetero_graph(**GRAPH), Config(**PIPE), device="cpu")
    store = InMemoryGraphStore(*_store_args(random_hetero_graph(**GRAPH)))
    logs = []
    stats = pipe.run_pipeline(Config(**dict(PIPE, epochs=2)), data,
                              model_dir=str(tmp_path / "port"), log_fn=logs.append,
                              randomization=False, resume=True, graph_store=store,
                              device="cpu")
    assert any("Resuming from checkpoint (epoch 1)" in line for line in logs)
    assert len(stats.loss_curve) == len(jstats.loss_curve) == 1
    assert stats.loss == pytest.approx(jstats.loss, rel=1e-4)
    assert store.queries_served == jstore.queries_served > 0
