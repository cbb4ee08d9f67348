"""The full hybrid flow on the PyTorch port, on the CPU: LightGCN candidate
generation feeding the hetero encoder-decoder ranker through the LightGCN
matcher artifact (the reference's production configuration, "LightGCN +
heuristic matchers for candidates → hetero GNN ranking") — the port of
``tests/test_hybrid_pipeline.py``, with ``lightgcn_data_from_hetero`` as the
entry to the LightGCN stage."""
import numpy as np
import torch

from laplace_gnn_recommendation_tpu_torch.configs import Config, LightGCNConfig
from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
from laplace_gnn_recommendation_tpu_torch.data.graph import HostCSR
from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import lightgcn_data_from_hetero
from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import (
    LinkPredData,
    SplitAdjacency,
)
from laplace_gnn_recommendation_tpu_torch.data.matchers import (
    LightGCNMatcher,
    PopularItemsMatcher,
    UsersWithCommonItemsMatcher,
)
from laplace_gnn_recommendation_tpu_torch.data.splitting import train_test_split_by_time
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
from laplace_gnn_recommendation_tpu_torch.train import encdec_pipeline, lightgcn_pipeline


class TestHybridPipeline:
    def test_lightgcn_candidates_feed_ranker(self, tmp_path):
        g = random_hetero_graph(seed=6, num_users=80, num_items=60, avg_degree=8)

        # stage 1: LightGCN candidate generation → matcher artifact
        lcfg = LightGCNConfig(
            epochs=60, hidden_layer_size=16, batch_size=256, num_iterations=2,
            eval_every=100, learning_rate=1e-2, k=12, num_recommendations=16,
            artifact_dir=str(tmp_path),
        )
        ldata = lightgcn_data_from_hetero(g, device="cpu")
        lightgcn_pipeline.train(lcfg, ldata, export=True, log_fn=lambda *_: None, device="cpu")
        artifact = tmp_path / "lightgcn_output.npz"
        assert artifact.exists()

        # stage 2: hetero GNN ranking with the lightgcn matcher in the
        # candidate mix (the reference's fashion matcher preset)
        cfg = Config(
            epochs=2, batch_size=8, num_neighbors=16, n_hop_neighbors=2,
            hidden_layer_size=16, encoder_layer_output_size=8, k=6,
            candidate_pool_size=10, eval_every=1,
        )
        eu, ei = g.edges[EDGE_KEY]
        tr, va, te = train_test_split_by_time(eu)
        cum = {"train": tr, "val": tr | va, "test": tr | va | te}
        splits = {
            name: SplitAdjacency(
                user_csr=HostCSR.from_edges(eu[m], ei[m], 80, 60),
                item_csr=HostCSR.from_edges(ei[m], eu[m], 60, 80),
            )
            for name, m in cum.items()
        }
        matchers = {
            name: [
                LightGCNMatcher(cfg.candidate_pool_size, str(artifact)),
                PopularItemsMatcher(cfg.candidate_pool_size, np.arange(60)),
                UsersWithCommonItemsMatcher(
                    cfg.candidate_pool_size, splits[name].user_csr, splits[name].item_csr,
                ),
            ]
            for name in ("val", "test")
        }
        data = LinkPredData(
            num_users=80, num_items=60,
            user_features=torch.from_numpy(g.node_features[EDGE_KEY.src].astype(np.int64)),
            item_features=torch.from_numpy(g.node_features[EDGE_KEY.dst].astype(np.int64)),
            splits=splits, matchers=matchers, graph=g,
        )
        stats = encdec_pipeline.run_pipeline(cfg, data, log_fn=lambda *_: None, device="cpu")
        assert np.isfinite(stats.loss)
        assert stats.recall_test >= 0.0

    def test_lightgcn_matcher_serves_artifact(self, tmp_path):
        recs = np.tile(np.arange(16, dtype=np.int32), (5, 1))
        np.savez_compressed(tmp_path / "out.npz", recommendations=recs)
        m = LightGCNMatcher(8, str(tmp_path / "out.npz"))
        np.testing.assert_array_equal(m.get_matches(3), np.arange(8))
