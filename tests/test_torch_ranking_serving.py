"""``RankingServer`` and the submission writer of the PyTorch port against
the JAX package's (``serving.RankingServer``, ``train/submission.py``), on
the same weights (``sage_params_from_jax``) and the same sampler seed, so
both servers rank identical candidate grids: the ids must be EQUAL (scores
agree to ~1e-6, far inside the gaps between distinct logits). Plus the
ports of ``tests/test_serving.py``'s ``RankingServer`` cases: cold users,
the k clamp to the label grid and the reference-quirk mode.

Top-k order among ties: ``jax.lax.top_k`` returns the lowest index first;
the port sorts stably (``ops.topk.top_k_lowest_first``), pinned below on
rows full of ties.
"""
import jax
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu import serving as jserving
from laplace_gnn_recommendation_tpu.configs import Config as JConfig
from laplace_gnn_recommendation_tpu.data import link_pred_data as jlpd
from laplace_gnn_recommendation_tpu.data import synthetic as jsynth
from laplace_gnn_recommendation_tpu.models import sage as jsage
from laplace_gnn_recommendation_tpu.train import submission as jsub
from laplace_gnn_recommendation_tpu_torch.configs import Config
from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
from laplace_gnn_recommendation_tpu_torch.data import link_pred_data as tlpd
from laplace_gnn_recommendation_tpu_torch.data.graph import HeteroGraph
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
from laplace_gnn_recommendation_tpu_torch.models import sage
from laplace_gnn_recommendation_tpu_torch.ops.topk import top_k_lowest_first
from laplace_gnn_recommendation_tpu_torch.serving import RankingServer
from laplace_gnn_recommendation_tpu_torch.train import submission as tsub

CFG = dict(epochs=1, batch_size=8, num_neighbors=8, n_hop_neighbors=2,
           hidden_layer_size=16, encoder_layer_output_size=8, num_gnn_layers=2,
           num_linear_layers=2, k=4, candidate_pool_size=8, positive_edges_ratio=0.5,
           negative_edges_ratio=2.0, p_dropout_features=0.0, batch_norm=True, seed=1)
GRAPH = dict(seed=6, num_users=50, num_items=40, avg_degree=6)


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = JConfig(**CFG), Config(**CFG)
    jd = jlpd.create_link_pred_data(jsynth.random_hetero_graph(**GRAPH), jcfg)
    td = tlpd.create_link_pred_data(random_hetero_graph(**GRAPH), tcfg, device="cpu")
    jp, jbn = jsage.init_sage_params(jax.random.PRNGKey(0), jcfg,
                                     jsage.get_feature_info(jd.graph))
    tp, tbn = sage.sage_params_from_jax(jax.tree.map(np.asarray, jp),
                                        jax.tree.map(np.asarray, jbn), device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jd=jd, td=td, jp=jp, jbn=jbn, tp=tp, tbn=tbn)


def _servers(s, **kw):
    return (jserving.RankingServer(s["jcfg"], s["jd"], s["jp"], s["jbn"], **kw),
            RankingServer(s["tcfg"], s["td"], s["tp"], s["tbn"], **kw))


@pytest.mark.parametrize("exclude_seen", [True, False])
@pytest.mark.parametrize("k", [1, 4, 7])
def test_ids_equal_jax(served, k, exclude_seen):
    js, ts = _servers(served, exclude_seen=exclude_seen)
    users = np.array([3, 0, 17, 17, 9, 44, 1, 2, 5, 30, 31, 12])   # 1.5 batches
    for _ in range(2):   # the sampler's stream advances per call in both
        np.testing.assert_array_equal(ts.recommend(users, k=k), js.recommend(users, k=k))


def test_recommend_shapes_and_candidate_only(served):
    _, srv = _servers(served)
    users = np.arange(10)
    recs = srv.recommend(users, k=4)
    assert recs.shape == (10, 4) and recs.dtype == np.int32
    test_csr = served["td"].splits["test"].user_csr
    for row, u in enumerate(users):
        got = [i for i in recs[row].tolist() if i >= 0]
        assert not (set(test_csr.neighbors(int(u)).tolist()) & set(got))
        assert len(got) == len(set(got))
    assert srv.recommend(np.array([3, 4, 5]), k=3).shape == (3, 3)


def test_cold_users_get_all_minus_one(served):
    g = random_hetero_graph(**GRAPH)
    uf = g.node_features[EDGE_KEY.src]
    g_cold = HeteroGraph(
        node_features={**g.node_features, EDGE_KEY.src: np.concatenate([uf, uf[:2]], axis=0)},
        edges=g.edges, num_nodes={**g.num_nodes, EDGE_KEY.src: 52},
    )
    d2 = tlpd.create_link_pred_data(g_cold, served["tcfg"], device="cpu")
    recs = RankingServer(served["tcfg"], d2, served["tp"], served["tbn"]).recommend(
        np.array([0, 50, 1, 51, 2]), k=4)
    assert recs.shape == (5, 4)
    assert (recs[1] == -1).all() and (recs[3] == -1).all()
    warm = RankingServer(served["tcfg"], d2, served["tp"], served["tbn"]).recommend(
        np.array([0, 1, 2]), k=4)
    np.testing.assert_array_equal(recs[[0, 2, 4]], warm)
    assert (recs[0] >= 0).any()


def test_k_larger_than_candidate_grid_clamps(served):
    _, a = _servers(served)
    width = a.sampler.budgets.labels_per_user
    recs = a.recommend(np.array([0, 1, 2]), k=width + 7)
    assert recs.shape == (3, width + 7) and (recs[:, width:] == -1).all()
    _, b = _servers(served)
    np.testing.assert_array_equal(recs[:, :width], b.recommend(np.array([0, 1, 2]), k=width))
    _, c = _servers(served)
    jc, _ = _servers(served)
    np.testing.assert_array_equal(c.recommend(np.array([0, 1, 2]), k=width + 7),
                                  jc.recommend(np.array([0, 1, 2]), k=width + 7))


def test_reference_quirk_mode_allows_xor_positives(served):
    _, strict_srv = _servers(served)
    _, lax_srv = _servers(served, exclude_seen=False)
    users = np.arange(20)
    strict, lax = strict_srv.recommend(users, k=4), lax_srv.recommend(users, k=4)
    test_csr = served["td"].splits["test"].user_csr
    for row, u in enumerate(users):
        seen = set(test_csr.neighbors(int(u)).tolist())
        assert not (seen & {i for i in strict[row].tolist() if i >= 0})
        # lax mode's extra items (if any) can only be label-0 re-entries
        extra = set(lax[row].tolist()) - set(strict[row].tolist()) - {-1}
        cands = set()
        for m in served["td"].matchers["test"]:
            cands |= set(np.asarray(m.get_matches(int(u))).tolist())
        assert extra <= (cands | seen)


def test_make_predictions_equal_jax(served):
    jt = jlpd.create_samplers(served["jcfg"], served["jd"], seed=0)[2]
    tt = tlpd.create_samplers(served["tcfg"], served["td"], seed=0)[2]
    jpred = jsub.make_predictions(served["jcfg"], served["jp"], served["jbn"], served["jd"], jt)
    tpred = tsub.make_predictions(served["tcfg"], served["tp"], served["tbn"], served["td"], tt)
    assert sorted(jpred) == sorted(tpred)
    for u in jpred:
        np.testing.assert_array_equal(tpred[u], np.asarray(jpred[u]))


def test_raw_ids_and_csv(tmp_path):
    preds = {1: np.array([2, -1, 0]), 0: np.array([1, 1, -1])}
    cmap = {"0": "c0", "1": "c1"}
    amap = {"0": 100, "1": 101, "2": 102}
    assert tsub.map_to_raw_ids(preds, cmap, amap) == jsub.map_to_raw_ids(preds, cmap, amap)
    customers, strs = tsub.map_to_raw_ids(preds, cmap, amap)
    assert customers == ["c0", "c1"] and strs == ["101 101", "102 100"]
    tsub.save_csv(str(tmp_path / "a" / "t.csv"), customers, strs)
    jsub.save_csv(str(tmp_path / "j.csv"), customers, strs)
    assert (tmp_path / "a" / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


@pytest.mark.parametrize("k", [1, 3, 8])
def test_top_k_ties_lowest_index_first(k):
    """The rule the servers rely on, against ``jax.lax.top_k`` on rows with
    many exact ties (pad slots all hold INFER_PAD)."""
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 3, (6, 10)).astype(np.float32)
    scores[0] = sage.INFER_PAD
    scores[1, 4:] = sage.INFER_PAD
    jv, ji = jax.lax.top_k(scores, k)
    tv, ti = top_k_lowest_first(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
