"""Entry points of the port beside the JAX package's ``__graft_entry__.py``:
a single-device forward on the flagship model and a dry run of the public
pipelines over an n-rank mesh.

    python -m laplace_gnn_recommendation_tpu_torch.graft_entry [n] [device]

prints ``entry loss:`` and, after ``dryrun_multichip(n)``, ``dryrun ok``.
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np


def _tiny_problem(num_users=256, num_items=512, pad_multiple=128, seed=0, device="cuda"):
    from .data.graph import BipartiteGraph
    from .data.synthetic import random_bipartite_edges

    eu, ei = random_bipartite_edges(seed=seed, num_users=num_users, num_items=num_items,
                                    avg_degree=8)
    return BipartiteGraph.from_edges(eu, ei, num_users, num_items,
                                     pad_multiple=pad_multiple, device=device)


def entry(device="cuda"):
    """(fn, example_args): the LightGCN K-hop diffusion (K=3) over a fixed
    graph, then the BPR loss of a (user, pos, neg) batch —
    ``fn(user_emb, item_emb, u, pos, neg)``; the arguments are drawn as the
    JAX ``__graft_entry__.entry()`` draws them (``__graft_entry__.py:5-53``),
    so the two losses agree."""
    import torch

    from .models.lightgcn import LightGCNParams, bpr_loss, lightgcn_forward

    g = _tiny_problem(device=device)
    dev = g.device
    k_iter = 3

    def fn(user_emb, item_emb, u, pos, neg):
        params = LightGCNParams(user_emb=user_emb, item_emb=item_emb)
        uf, u0, itf, it0 = lightgcn_forward(params, g, k_iter)
        u, pos, neg = u.long(), pos.long(), neg.long()
        return bpr_loss(uf[u], u0[u], itf[pos], it0[pos], itf[neg], it0[neg], 1e-6)

    rng = np.random.default_rng(0)
    eu, ei = g.edges_host()
    idx = rng.integers(0, g.num_edges, 64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    example_args = (
        t(rng.normal(size=(g.num_users, 32)).astype(np.float32)),
        t(rng.normal(size=(g.num_items, 32)).astype(np.float32)),
        t(eu[idx].astype(np.int32)),
        t(ei[idx].astype(np.int32)),
        t(rng.integers(0, g.num_items, 64).astype(np.int32)),
    )
    return fn, example_args


def _dryrun_rank(device):
    """The dry run's surfaces on this rank (``__graft_entry__.py:54-191``);
    returns a dict of what each surface gave."""
    import torch
    import torch.distributed as dist

    from .configs import Config, LightGCNConfig
    from .constants import EDGE_KEY, NODE_ITEM, NODE_USER
    from .data.graph import HostCSR
    from .data.lightgcn_data import create_lightgcn_data
    from .data.link_pred_data import create_link_pred_data
    from .data.pinsage_data import PinSAGEData
    from .data.store_sampler import InMemoryGraphStore
    from .data.synthetic import random_bipartite_edges, random_hetero_graph
    from .parallel.mesh import DATA_AXIS, build_mesh
    from .serving import RetrievalServer
    from .train import encdec_pipeline, pinsage_pipeline
    from .train.lightgcn_pipeline import train
    from .train.submission import submission_pipeline

    n = dist.get_world_size()
    dev = torch.device(device if device is not None else f"cuda:{dist.get_rank()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    model_axis = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = build_mesh(n // model_axis, model_axis, device=dev)
    quiet = lambda *a: None  # noqa: E731
    out = {"mesh": (mesh.size(DATA_AXIS), model_axis)}

    # LightGCN: the public train() with export; node counts that do not
    # divide the model axis, so the pad and masking paths run too
    eu, ei = random_bipartite_edges(seed=3, num_users=203, num_items=301, avg_degree=10)
    data = create_lightgcn_data(eu, ei, 203, 301, pad_multiple=128, device=mesh.device)
    cfg = LightGCNConfig(epochs=3, eval_every=2, hidden_layer_size=16, num_iterations=2,
                         batch_size=8 * mesh.size(DATA_AXIS), num_recommendations=8)
    # one directory for every rank: rank 0 makes it and writes the artifacts
    tmp = _shared_tmpdir(mesh)
    try:
        cfg.artifact_dir = tmp
        stats = train(cfg, data, export=True, log_fn=quiet, mesh=mesh)
        assert np.isfinite(stats.loss), stats
        out["lightgcn_loss"] = stats.loss

        # serving: sharded retrieval over the artifacts train() just wrote
        server = RetrievalServer.from_lightgcn_artifacts(
            tmp, k=8, exclude_edges=data.train_edges, batch_size=32, mesh=mesh)
        items, vals = server.recommend(np.arange(40))
        assert items.shape == (40, 8) and (items < 301).all()
        assert np.isfinite(vals).all()
        out["retrieval"] = items

        # hetero encoder-decoder: the public run_pipeline() on the same mesh
        hg = random_hetero_graph(seed=1, num_users=48, num_items=40, avg_degree=4)
        ecfg = Config(
            epochs=2, batch_size=max(mesh.size(DATA_AXIS), 2) * 4, num_neighbors=8,
            n_hop_neighbors=2, hidden_layer_size=16, encoder_layer_output_size=8,
            k=4, candidate_pool_size=4, eval_every=1,
        )
        ldata = create_link_pred_data(hg, ecfg, device=mesh.device)
        estats, eparams, ebn = encdec_pipeline.run_pipeline(
            ecfg, ldata, log_fn=quiet, randomization=False, mesh=mesh, return_state=True)
        assert np.isfinite(estats.loss), estats
        out["encdec_loss"] = estats.loss

        # submission writer: inference on the mesh → MAP@12 CSV
        path = submission_pipeline(
            ecfg, ldata,
            {str(u): f"c{u:03d}" for u in range(48)},
            {str(i): f"a{i:03d}" for i in range(40)},
            out_path=os.path.join(tmp, "submission.csv"),
            params_bn=(eparams, ebn), mesh=mesh,
        )
        lines = open(path).read().strip().splitlines()
        assert lines[0] == "customer_id,prediction" and len(lines) > 1
        out["submission_rows"] = len(lines) - 1
    finally:
        from .parallel.collectives import barrier

        barrier(mesh)
        if mesh.is_coordinator:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)

    # the DB-backed ranking stack: the same run_pipeline with the sampler
    # answering its neighbourhood Cypher from a graph store (the reference's
    # config.neo4j flow) on the same mesh
    s_, d_ = hg.edges[EDGE_KEY]
    store = InMemoryGraphStore({NODE_USER: NODE_USER, NODE_ITEM: NODE_ITEM},
                               {EDGE_KEY: (s_, d_)}, {EDGE_KEY: np.zeros(len(s_), np.int64)})
    sstats = encdec_pipeline.run_pipeline(ecfg, ldata, log_fn=quiet, randomization=False,
                                          mesh=mesh, graph_store=store)
    assert np.isfinite(sstats.loss), sstats
    assert store.queries_served > 0
    out["graph_store"] = dict(loss=sstats.loss, queries_served=store.queries_served)

    # PinSAGE: the public train() with the pairs split over data and the
    # distributed HITS@k
    peu, pei = random_bipartite_edges(seed=4, num_users=32, num_items=48, avg_degree=5)
    latest = np.full(32, -1, np.int32)
    for u, i in zip(peu, pei):
        latest[u] = i
    val = [pei[peu == u][:1].astype(np.int64) for u in range(32)]
    pdata = PinSAGEData(
        num_users=32, num_items=48,
        user_csr=HostCSR.from_edges(peu, pei, 32, 48),
        item_csr=HostCSR.from_edges(pei, peu, 48, 32),
        item_features=np.zeros((48, 1), np.int32), item_features_float=None,
        latest_item_per_user=latest, val_items=val, test_items=val,
    )
    pcfg = pinsage_pipeline.PinSAGEConfig(num_epochs=1, batches_per_epoch=3, batch_size=8,
                                          hidden_dims=8, num_neighbors=2, k=4)
    pres = pinsage_pipeline.train(pcfg, pdata, log_fn=quiet, mesh=mesh)
    assert np.isfinite(pres["loss"]), pres["loss"]
    out["pinsage_loss"] = pres["loss"]
    return out


def _shared_tmpdir(mesh) -> str:
    """A temporary directory that rank 0 makes and every rank gets the path of."""
    from .parallel.collectives import all_gather_objects

    path = tempfile.mkdtemp(prefix="dryrun_") if mesh.is_coordinator else None
    return all_gather_objects(path, mesh)[0]


def dryrun_multichip(n_devices: int, device=None, backend=None, timeout: float = 900.0):
    """The public entry points over an ``n_devices``-rank (data, model) mesh
    on tiny shapes, each rank a spawned process (model axis 2 for an even
    count, else 1): ``lightgcn_pipeline.train()`` with export (row-sharded
    tables, sharded SpMM through kernel A, the DP-split BPR batch,
    distributed-top-k eval and export), ``RetrievalServer.recommend()`` on
    the exported tables, ``encdec_pipeline.run_pipeline()`` (row-sharded
    feature tables, the DP label grid), ``submission_pipeline()``, the same
    ``run_pipeline()`` with its neighbourhoods from an ``InMemoryGraphStore``
    (``graph_store=``), and PinSAGE ``train()``. ``device`` None puts rank
    r on ``cuda:r`` over NCCL; ``"cpu"`` runs over gloo; ``backend``
    overrides (two ranks can share one card over gloo). Returns each
    rank's results."""
    from .parallel.spawn import run_ranks

    if backend is None:
        backend = "gloo" if device is not None and str(device).startswith("cpu") else "nccl"
    return run_ranks(_dryrun_rank, n_devices, (device,), backend=backend, timeout=timeout)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    device = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    fn, args = entry(device=device)
    print("entry loss:", float(fn(*args)))
    dryrun_multichip(n, device=None if device == "cuda" else device)
    print("dryrun ok")
