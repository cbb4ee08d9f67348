"""The sharded path through the port's PUBLIC entry points on a 2×2 mesh
(four spawned gloo ranks on the CPU) against the port's one-rank run, with
the JAX package's tolerances (``tests/test_sharded_production.py``):
``lightgcn_pipeline.train()`` and ``export_artifacts()``,
``RetrievalServer.recommend()`` (also against the JAX package's
``sharded_mips_topk`` on its 8-device CPU mesh, and bit for bit against the
plain per-batch loop it replaced), the over-excluded user,
``encdec_pipeline.run_pipeline()`` and its sharded tables, a sharded
checkpoint and its resume, and PinSAGE ``train()``.

Parity basis: a sharded row sums the edges of the unsharded row in the same
order, the cross-shard lookup adds only zeros, the tables pad after init,
and every rank draws the global batch from the one seed; the data-parallel
split changes only the order of a few f32 sums.

All mesh runs happen in one spawn for the module; JAX is imported inside
the tests that use it, so the ranks import only the port.
"""
import os

import numpy as np
import pytest

from laplace_gnn_recommendation_tpu_torch.configs import Config, LightGCNConfig
from laplace_gnn_recommendation_tpu_torch.data.graph import HostCSR
from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import (
    create_lightgcn_data,
    padded_user_items,
)
from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import create_link_pred_data
from laplace_gnn_recommendation_tpu_torch.data.pinsage_data import PinSAGEData
from laplace_gnn_recommendation_tpu_torch.data.synthetic import (
    random_bipartite_edges,
    random_hetero_graph,
)

quiet = lambda *a: None  # noqa: E731


def _tiny_data():
    eu, ei = random_bipartite_edges(seed=3, num_users=203, num_items=301, avg_degree=10)
    return create_lightgcn_data(eu, ei, 203, 301, pad_multiple=128, device="cpu")


def _cfg(propagation, **kw):
    base = dict(epochs=10, eval_every=5, hidden_layer_size=16, num_iterations=2,
                batch_size=32, seed=7, propagation=propagation)
    base.update(kw)
    return LightGCNConfig(**base)


def _init_params():
    import torch

    from laplace_gnn_recommendation_tpu_torch.models.lightgcn import init_lightgcn

    data = _tiny_data()
    gen = torch.Generator().manual_seed(0)
    return init_lightgcn(data.num_users, data.num_items, 16, generator=gen, device="cpu")


def _retrieval_inputs():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(64, 16)).astype(np.float32)
    it = rng.normal(size=(301, 16)).astype(np.float32)  # 301 ∤ 2 → pads
    excl = (rng.integers(0, 64, 300), rng.integers(0, 301, 300))
    rng = np.random.default_rng(1)
    u2 = rng.normal(size=(32, 8)).astype(np.float32)
    it2 = rng.normal(size=(130, 8)).astype(np.float32)
    return u, it, excl, u2, it2


def _encdec_setup():
    g = random_hetero_graph(seed=2, num_users=48, num_items=40, avg_degree=5)
    cfg = Config(epochs=3, batch_size=8, num_neighbors=8, n_hop_neighbors=2,
                 hidden_layer_size=16, encoder_layer_output_size=8, k=4,
                 candidate_pool_size=4, eval_every=2, seed=11)
    return cfg, create_link_pred_data(g, cfg, device="cpu")


def _ckpt_cfg(epochs):
    return Config(epochs=epochs, batch_size=8, num_neighbors=6, n_hop_neighbors=2,
                  hidden_layer_size=8, encoder_layer_output_size=8, k=4, candidate_pool_size=4,
                  save_model=True, save_every=0.5, eval_every=1)


def _ckpt_data():
    g = random_hetero_graph(seed=6, num_users=24, num_items=20, avg_degree=4)
    return create_link_pred_data(g, _ckpt_cfg(2), device="cpu")


def _pinsage_setup():
    from laplace_gnn_recommendation_tpu_torch.train import pinsage_pipeline as P

    rng = np.random.default_rng(0)
    nu, ni = 40, 56
    eu, ei = random_bipartite_edges(seed=9, num_users=nu, num_items=ni, avg_degree=5)
    latest = np.full(nu, -1, np.int32)
    for u, i in zip(eu, ei):
        latest[u] = i
    val = [np.array([int(ei[j]) for j in np.flatnonzero(eu == u)[:1]]) for u in range(nu)]
    data = PinSAGEData(
        num_users=nu, num_items=ni,
        user_csr=HostCSR.from_edges(eu, ei, nu, ni),
        item_csr=HostCSR.from_edges(ei, eu, ni, nu),
        item_features=rng.integers(0, 5, (ni, 2)).astype(np.int32),
        item_features_float=None,
        latest_item_per_user=latest, val_items=val, test_items=val,
    )
    cfg = P.PinSAGEConfig(num_epochs=1, batches_per_epoch=4, batch_size=8, hidden_dims=8,
                          num_neighbors=2, k=4, seed=5)
    return cfg, data


LOOP_SIZES = (1, 7, 8, 9, 29)   # 1, B-1, B, B+1, 3B+5 at the server batch of 8


def _old_sharded_recommend(mesh, srv, users, ex_host, exc_host):
    """The sharded server's answer as its batch loop gave it before: host
    exclusion rows a batch, the distributed top-k with boolean-index
    exclusions on a cloned score block, each batch copied back on its own."""
    import torch

    from laplace_gnn_recommendation_tpu_torch.ops.topk import (
        EXCLUDE_FILL,
        hierarchical_topk,
        top_k_lowest_first,
    )
    from laplace_gnn_recommendation_tpu_torch.parallel.collectives import all_gather_dim0
    from laplace_gnn_recommendation_tpu_torch.parallel.mesh import MODEL_AXIS

    parts, n_block = mesh.size(MODEL_AXIS), srv.item_emb.shape[0]
    offset, b, k, n = mesh.rank(MODEL_AXIS) * n_block, srv.batch_size, srv.k, len(users)
    ids, scores = np.zeros((n, k), np.int32), np.zeros((n, k), np.float32)
    for s in range(0, n, b):
        e = min(s + b, n)
        chunk = np.pad(users[s:e], (0, b - (e - s)))
        ex, exc = torch.from_numpy(ex_host[chunk]), torch.from_numpy(exc_host[chunk])
        block = srv.user_emb[torch.from_numpy(chunk)] @ srv.item_emb.T
        col = offset + torch.arange(n_block)
        block = torch.where((col < srv.num_items)[None, :], block, torch.full((), -torch.inf))
        local = ex.long() - offset
        valid = ((local >= 0) & (local < n_block)
                 & (torch.arange(ex.shape[1])[None, :] < exc[:, None]))
        rows = torch.arange(b)[:, None].expand(b, ex.shape[1])
        block = block.clone()
        block[rows[valid], local[valid]] = EXCLUDE_FILL
        vals, idx = hierarchical_topk(block, min(k, n_block))
        idx = idx + offset
        vals = all_gather_dim0(vals[None], mesh, MODEL_AXIS).permute(1, 0, 2).reshape(b, -1)
        idx = all_gather_dim0(idx[None], mesh, MODEL_AXIS).permute(1, 0, 2).reshape(b, -1)
        mvals, mpos = top_k_lowest_first(vals, k)
        midx = torch.gather(idx, 1, mpos)
        midx = torch.where(torch.isfinite(mvals), midx, torch.zeros_like(midx))
        ids[s:e], scores[s:e] = midx.numpy()[: e - s], mvals.numpy()[: e - s]
    assert parts > 1 and srv.items_padded > srv.num_items
    return ids, scores


def _rank_runs(art_dir, ckpt_dir):
    """Every surface on one rank of the 2×2 mesh."""
    import torch

    from laplace_gnn_recommendation_tpu_torch.models import sage
    from laplace_gnn_recommendation_tpu_torch.models.lightgcn import LightGCNParams
    from laplace_gnn_recommendation_tpu_torch.ops.embedding import shard_table
    from laplace_gnn_recommendation_tpu_torch.ops.topk import sharded_mips_topk
    from laplace_gnn_recommendation_tpu_torch.parallel.mesh import build_mesh, shard_rows_pad
    from laplace_gnn_recommendation_tpu_torch.serving import RetrievalServer
    from laplace_gnn_recommendation_tpu_torch.train import encdec_pipeline
    from laplace_gnn_recommendation_tpu_torch.train import pinsage_pipeline as P
    from laplace_gnn_recommendation_tpu_torch.train.adam import Adam
    from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import (
        export_artifacts,
        select_propagation,
        train,
    )
    from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
    from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import create_samplers

    mesh = build_mesh(2, 2, device="cpu")
    out = {}
    data = _tiny_data()
    s = train(_cfg("auto"), data, export=False, log_fn=quiet, mesh=mesh)
    out["train"] = (s.loss, s.recall_test, s.precision_test, s.recall_val)
    g = BipartiteGraph.from_edges(*random_bipartite_edges(0, 256, 512, 6), 256, 512, device="cpu")
    out["operand"] = type(select_propagation(_cfg("auto"), g, mesh)).__name__

    # export through the distributed top-k, from padded row blocks
    p = _init_params()
    u_pad, i_pad = shard_rows_pad(data.num_users, mesh), shard_rows_pad(data.num_items, mesh)
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[0]))  # noqa: E731
    padded = LightGCNParams(shard_table(mesh, pad(p.user_emb, u_pad)),
                            shard_table(mesh, pad(p.item_emb, i_pad)))
    out["export"] = export_artifacts(padded, data, _cfg("auto", num_recommendations=16),
                                     art_dir, mesh=mesh)

    # retrieval with and without exclusions
    u, it, excl, u2, it2 = _retrieval_inputs()
    srv = RetrievalServer(u, it, k=8, exclude_edges=excl, batch_size=32, mesh=mesh)
    out["retrieval_padded"] = (srv._sharded, srv.items_padded)
    out["retrieval"] = srv.recommend(np.arange(50))
    out["retrieval_plain"] = RetrievalServer(u2, it2, k=5, batch_size=16,
                                             mesh=mesh).recommend(np.arange(20))

    # the server loop against the plain per-batch loop, at request sizes
    # around its batch of 8
    loop_srv = RetrievalServer(u, it, k=8, exclude_edges=excl, batch_size=8, mesh=mesh)
    ex_host, exc_host = padded_user_items(np.arange(64, dtype=np.int32),
                                          excl[0].astype(np.int64), excl[1])
    for n in LOOP_SIZES:
        users = np.random.default_rng(n).integers(0, 64, n)
        out[f"loop_{n}"] = (*loop_srv.recommend(users),
                            *_old_sharded_recommend(mesh, loop_srv, users, ex_host, exc_host))

    # the over-excluded user: 9 real items padded to 10 rows, 7 excluded, k=5
    rng = np.random.default_rng(0)
    items = np.zeros((10, 8), np.float32)
    items[:9] = rng.normal(size=(9, 8))
    q = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    ex = torch.from_numpy(np.tile(np.arange(7), (4, 1)))
    _, idx = sharded_mips_topk(mesh, q, shard_table(mesh, torch.from_numpy(items)), 5, ex,
                               torch.full((4,), 7), num_valid_items=9)
    out["over_excluded"] = idx.numpy()

    # encoder-decoder
    ecfg, edata = _encdec_setup()
    es = encdec_pipeline.run_pipeline(ecfg, edata, log_fn=quiet, randomization=False,
                                      mesh=mesh, device="cpu")
    out["encdec"] = (es.loss, es.recall_test, es.precision_test)

    # the feature tables are sharded and train through the cross-shard lookup
    g = random_hetero_graph(seed=4, num_users=32, num_items=24, avg_degree=4)
    tcfg = Config(epochs=1, batch_size=8, num_neighbors=6, n_hop_neighbors=2,
                  hidden_layer_size=8, encoder_layer_output_size=8, k=4, candidate_pool_size=4)
    tdata = create_link_pred_data(g, tcfg, device="cpu")
    params, bn = sage.init_sage_params(tcfg, sage.get_feature_info(g),
                                       generator=torch.Generator().manual_seed(0),
                                       device="cpu", mesh=mesh)
    info = sage.get_feature_info(g)["customer"]
    out["table_rows"] = [(t.shape[0], c + 1) for t, c in
                         zip(params.embeddings["customer"], info.num_cat)]
    train_s, _, _ = create_samplers(tcfg, tdata, randomization=False)
    batch = train_s.sample_batch(np.arange(tcfg.batch_size))
    tx = Adam(1e-2)
    step = encdec_pipeline.make_train_step(tcfg, tdata, tx, mesh)
    before = params.embeddings["customer"][0].detach().clone()
    _, _, _, loss = step(params, bn, tx.init(sage.jax_tree(params)), batch,
                         torch.Generator().manual_seed(1))
    out["tables_train"] = (float(loss),
                           not torch.equal(before, params.embeddings["customer"][0].detach()))

    # a sharded checkpoint, and a resume from it through run_pipeline
    cdata = _ckpt_data()
    encdec_pipeline.run_pipeline(_ckpt_cfg(2), cdata, model_dir=ckpt_dir, log_fn=quiet,
                                 randomization=False, mesh=mesh, device="cpu")
    out["ckpt_files"] = sorted(os.listdir(ckpt_dir))
    logs = []
    rs = encdec_pipeline.run_pipeline(_ckpt_cfg(3), cdata, model_dir=ckpt_dir,
                                      log_fn=logs.append, randomization=False, mesh=mesh,
                                      resume=True, device="cpu")
    out["resume"] = (rs.loss, any("Resuming from checkpoint" in x for x in logs))

    pcfg, pdata = _pinsage_setup()
    r = P.train(pcfg, pdata, log_fn=quiet, mesh=mesh)
    out["pinsage"] = (r["loss"], r["test_hits"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from laplace_gnn_recommendation_tpu_torch.parallel.spawn import run_ranks

    art = str(tmp_path_factory.mktemp("sharded_art"))
    ckpt = str(tmp_path_factory.mktemp("sharded_ckpt"))
    return run_ranks(_rank_runs, 4, (art, ckpt), timeout=600)


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        a, b = ranks[0][key], r[key]
        if isinstance(a, tuple) and isinstance(a[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, key
    return ranks[0][key]


class TestLightGCNSharded:
    def test_public_train_parity(self, ranks):
        from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import train

        s1 = train(_cfg("plain"), _tiny_data(), export=False, log_fn=quiet, device="cpu")
        loss, recall_test, precision_test, recall_val = _same_on_every_rank(ranks, "train")
        assert abs(s1.loss - loss) < 1e-4, (s1.loss, loss)
        assert s1.recall_test == pytest.approx(recall_test, abs=1e-9)
        assert s1.precision_test == pytest.approx(precision_test, abs=1e-9)
        assert s1.recall_val == pytest.approx(recall_val, abs=1e-9)

    def test_selects_sharded_operand(self, ranks):
        from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
        from laplace_gnn_recommendation_tpu_torch.ops.spmm_dense import DenseAdjacency
        from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import (
            select_propagation,
        )

        assert _same_on_every_rank(ranks, "operand") == "ShardedBipartiteGraph"
        g = BipartiteGraph.from_edges(*random_bipartite_edges(0, 256, 512, 6), 256, 512,
                                      device="cpu")
        assert isinstance(select_propagation(_cfg("auto"), g, None), DenseAdjacency)

    def test_export_artifacts_parity(self, ranks, tmp_path):
        from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import export_artifacts

        out1 = export_artifacts(_init_params(), _tiny_data(),
                                _cfg("auto", num_recommendations=16), str(tmp_path))
        np.testing.assert_array_equal(out1, _same_on_every_rank(ranks, "export"))


class TestRetrievalServerSharded:
    def test_recommend_parity_with_exclusions(self, ranks):
        from laplace_gnn_recommendation_tpu_torch.serving import RetrievalServer

        u, it, excl, _, _ = _retrieval_inputs()
        sharded, padded = _same_on_every_rank(ranks, "retrieval_padded")
        assert sharded and padded % 2 == 0
        i1, v1 = RetrievalServer(u, it, k=8, exclude_edges=excl, batch_size=32,
                                 device="cpu").recommend(np.arange(50))
        i2, v2 = _same_on_every_rank(ranks, "retrieval")
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-5)
        assert (i2 < 301).all()

    @pytest.mark.parametrize("n", LOOP_SIZES)
    def test_recommend_equals_per_batch_loop(self, ranks, n):
        """The sharded tier's batch loop (exclusion rows gathered on the
        device, one upload and one readback) against the plain per-batch
        loop on the same mesh: ids equal, scores bit-equal."""
        ids, scores, ref_ids, ref_scores = _same_on_every_rank(ranks, f"loop_{n}")
        assert ids.shape == (n, 8) and ids.dtype == np.int32 and scores.dtype == np.float32
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(scores.view(np.int32), ref_scores.view(np.int32))

    def test_recommend_parity_no_exclusions(self, ranks):
        from laplace_gnn_recommendation_tpu_torch.serving import RetrievalServer

        _, _, _, u2, it2 = _retrieval_inputs()
        i1, _ = RetrievalServer(u2, it2, k=5, batch_size=16, device="cpu").recommend(np.arange(20))
        np.testing.assert_array_equal(i1, _same_on_every_rank(ranks, "retrieval_plain")[0])

    @pytest.mark.parametrize("exclusions", [True, False])
    def test_recommend_equals_jax_sharded_mips(self, ranks, mesh8, exclusions):
        from laplace_gnn_recommendation_tpu.serving import RetrievalServer as JServer

        u, it, excl, u2, it2 = _retrieval_inputs()
        if exclusions:
            jsrv = JServer(u, it, k=8, exclude_edges=excl, batch_size=32, mesh=mesh8)
            ji, jv = jsrv.recommend(np.arange(50))
            mi, mv = _same_on_every_rank(ranks, "retrieval")
        else:
            jsrv = JServer(u2, it2, k=5, batch_size=16, mesh=mesh8)
            ji, jv = jsrv.recommend(np.arange(20))
            mi, mv = _same_on_every_rank(ranks, "retrieval_plain")
        assert jsrv._sharded
        np.testing.assert_array_equal(mi, ji)
        np.testing.assert_allclose(mv, jv, rtol=1e-6)

    def test_over_excluded_user_stays_in_catalog(self, ranks):
        idx = _same_on_every_rank(ranks, "over_excluded")
        assert (idx < 9).all(), idx
        # the two real unmasked items outrank everything else
        for row in idx:
            assert set(row[:2].tolist()) == {7, 8}


class TestEncDecSharded:
    def test_run_pipeline_parity(self, ranks):
        from laplace_gnn_recommendation_tpu_torch.train.encdec_pipeline import run_pipeline

        cfg, data = _encdec_setup()
        s1 = run_pipeline(cfg, data, log_fn=quiet, randomization=False, device="cpu")
        loss, recall, precision = _same_on_every_rank(ranks, "encdec")
        assert s1.loss == pytest.approx(loss, rel=1e-4)
        assert s1.recall_test == pytest.approx(recall, abs=1e-6)
        assert s1.precision_test == pytest.approx(precision, abs=1e-6)

    def test_sharded_tables_train(self, ranks):
        table_rows = _same_on_every_rank(ranks, "table_rows")
        assert table_rows
        for rows, true_rows in table_rows:
            # a row block of a table padded to divide the 2-wide model axis
            assert rows * 2 == true_rows + true_rows % 2
        for r in ranks:
            loss, changed = r["tables_train"]
            assert np.isfinite(loss) and changed

    def test_sharded_checkpoint_resumes(self, ranks):
        files = _same_on_every_rank(ranks, "ckpt_files")
        assert any(f.endswith(".dcp") for f in files), files
        assert not any(f.endswith(".npz") for f in files), files
        loss, resumed = _same_on_every_rank(ranks, "resume")
        assert resumed and np.isfinite(loss)


class TestPinSAGESharded:
    def test_train_mesh_parity(self, ranks):
        from laplace_gnn_recommendation_tpu_torch.train import pinsage_pipeline as P

        cfg, data = _pinsage_setup()
        r1 = P.train(cfg, data, log_fn=quiet, device="cpu")
        loss, hits = _same_on_every_rank(ranks, "pinsage")
        assert r1["loss"] == pytest.approx(loss, rel=1e-4)
        assert r1["test_hits"] == pytest.approx(hits, abs=1e-9)
