"""The PinSAGE case of ``tests/test_synthetic_learnability.py`` on the
PyTorch port, on the CPU: latest-item retrieval after training on a
clustered graph beats the popularity baseline's HITS@k under the same
protocol (exclude interacted items, a hit is any top-k item in the ground
truth), by the JAX test's margin (1.3×)."""
import numpy as np

from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
from laplace_gnn_recommendation_tpu_torch.data.etl import LinkPredArtifacts
from laplace_gnn_recommendation_tpu_torch.data.graph import HeteroGraph
from laplace_gnn_recommendation_tpu_torch.data.pinsage_data import build_pinsage_data
from laplace_gnn_recommendation_tpu_torch.data.splitting import train_test_split_by_time
from laplace_gnn_recommendation_tpu_torch.data.synthetic import latent_bipartite_edges
from laplace_gnn_recommendation_tpu_torch.train.pinsage_pipeline import PinSAGEConfig, train


def test_pinsage_beats_popularity_hits():
    n_u, n_i, k = 300, 150, 10
    eu, ei, _, _ = latent_bipartite_edges(seed=13, num_users=n_u, num_items=n_i, avg_degree=14,
                                          num_clusters=10, in_cluster_p=0.9)
    g = HeteroGraph(
        node_features={EDGE_KEY.src: np.arange(n_u, dtype=np.int32)[:, None],
                       EDGE_KEY.dst: np.arange(n_i, dtype=np.int32)[:, None]},
        edges={EDGE_KEY: (np.asarray(eu, np.int64), np.asarray(ei, np.int64))},
        num_nodes={EDGE_KEY.src: n_u, EDGE_KEY.dst: n_i},
    )
    tr, va, te = train_test_split_by_time(np.asarray(eu, np.int64))
    a = LinkPredArtifacts(graph=g, train_mask=tr, val_mask=va, test_mask=te,
                          customer_id_map_forward={}, article_id_map_forward={})
    pdata = build_pinsage_data(a)
    cfg = PinSAGEConfig(num_epochs=3, batches_per_epoch=120, batch_size=32, hidden_dims=32,
                        lr=3e-3, k=k, seed=0)
    out = train(cfg, pdata, log_fn=lambda *_: None, device="cpu")
    pop_order = np.argsort(-np.bincount(np.asarray(ei)[a.train_mask], minlength=n_i),
                           kind="stable")
    hits = []
    for u in range(pdata.num_users):
        gt = pdata.test_items[u]
        if len(gt) == 0 or pdata.latest_item_per_user[u] < 0:
            continue
        seen = set(pdata.user_csr.neighbors(u).tolist())
        recs = [i for i in pop_order if i not in seen][:k]
        hits.append(bool(set(recs) & set(gt)))
    pop_hits = float(np.mean(hits))
    assert pop_hits > 0.0
    assert out["test_hits"] > 1.3 * pop_hits, (out["test_hits"], pop_hits)
