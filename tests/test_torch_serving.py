"""The serving slice of the PyTorch port as a whole, against the same flow
in the JAX package: edges → graph → ``lightgcn_forward`` (K=3, D=16) →
``RetrievalServer.recommend`` over a request that is not a multiple of the
batch, with train-item exclusions; plus eval metrics and the artifact
round trip.

Tolerances: propagated embeddings within atol=1e-5 (f32 sums in another
order, K hops); retrieval scores within rtol=1e-5, atol=1e-6 of JAX's, and
ids equal as sets per row except where the two sides' scores tie within
that tolerance at the k-th place. The quantized server is compared with
JAX's ``streaming_mips_topk_int8`` (interpret mode) on the same padded
catalog and mask, because the JAX server drops ``quantized`` off-TPU: ids
bitwise, scores to rtol=1e-6 (XLA's CPU code rounds some dequantized
scores one ulp away from (raw · su) · si, which the port computes exactly).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from laplace_gnn_recommendation_tpu import configs as jconfigs
from laplace_gnn_recommendation_tpu import serving as jserving
from laplace_gnn_recommendation_tpu.data import lightgcn_data as jdata
from laplace_gnn_recommendation_tpu.models import lightgcn as jlgcn
from laplace_gnn_recommendation_tpu.ops import topk_pallas as jtp
from laplace_gnn_recommendation_tpu.train import lightgcn_pipeline as jpipe
from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import create_lightgcn_data
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
from laplace_gnn_recommendation_tpu_torch.models.lightgcn import (
    lightgcn_forward,
    lightgcn_params_from_jax,
)
from laplace_gnn_recommendation_tpu_torch.serving import QUANTIZED_TILE, RetrievalServer
from laplace_gnn_recommendation_tpu_torch.train import lightgcn_pipeline as tpipe

U, I, D, K = 150, 300, 16, 3
BATCH, N_REQ, TOPK = 64, 150, 12   # 150 = 2 full batches + a 22-user tail
HOPS_ATOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
INT8_RTOL = 1e-6   # XLA's CPU dequantize rounds some su·si products 1 ulp apart


@pytest.fixture(scope="module")
def flow():
    eu, ei = random_bipartite_edges(0, U, I, 10.0, 0.8)
    jd = jdata.create_lightgcn_data(eu, ei, U, I)
    td = create_lightgcn_data(eu, ei, U, I, device="cpu")
    rng = np.random.default_rng(0)
    ue = (rng.normal(size=(U, D)) * 0.1).astype(np.float32)
    ie = (rng.normal(size=(I, D)) * 0.1).astype(np.float32)
    jparams = jlgcn.LightGCNParams(jnp.asarray(ue), jnp.asarray(ie))
    tparams = lightgcn_params_from_jax(ue, ie, device="cpu")
    jout = jlgcn.lightgcn_forward(jparams, jd.train_graph, K)
    cfg = LightGCNConfig(propagation="pallas", num_iterations=K)
    tout = lightgcn_forward(tparams, tpipe.select_propagation(cfg, td.train_graph), K)
    return dict(jd=jd, td=td, jparams=jparams, tparams=tparams, jout=jout, tout=tout,
                req=np.random.default_rng(1).permutation(U)[:N_REQ])


def _assert_topk_agree(ids_a, sc_a, ids_b, sc_b):
    np.testing.assert_allclose(sc_a, sc_b, rtol=RTOL, atol=ATOL)
    for ra, sa, rb, sb in zip(ids_a, sc_a, ids_b, sc_b):
        diff = set(ra.tolist()) ^ set(rb.tolist())
        if diff:   # only near-ties at the k-th place may swap
            kth = min(sa[-1], sb[-1])
            assert abs(sa[-1] - sb[-1]) <= ATOL + RTOL * abs(kth), (ra, rb)


def test_forward_matches_jax(flow):
    for a, b in zip(flow["tout"], flow["jout"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=HOPS_ATOL)


def test_f32_server_matches_jax(flow):
    tr = flow["td"].train_edges
    jsrv = jserving.RetrievalServer(np.asarray(flow["jout"][0]), np.asarray(flow["jout"][2]),
                                    k=TOPK, exclude_edges=tr, batch_size=BATCH)
    tsrv = RetrievalServer(flow["tout"][0], flow["tout"][2], k=TOPK, exclude_edges=tr,
                           batch_size=BATCH, device="cpu")
    ji, js = jsrv.recommend(flow["req"])
    ti, ts = tsrv.recommend(flow["req"])
    assert ti.shape == (N_REQ, TOPK) and ti.dtype == np.int32
    _assert_topk_agree(ti, ts, ji, js)
    seen = tsrv._ex.numpy()[flow["req"]]
    assert not (ti[:, :, None] == seen[:, None, :]).any()


def test_quantized_server_matches_jax_int8_kernel(flow):
    """The quantized server (kernel C's plain version here) against the JAX
    Pallas int8 kernel in interpret mode on the same padded catalog + mask."""
    tr = flow["td"].train_edges
    uf, itf = flow["tout"][0].numpy(), flow["tout"][2].numpy()
    tsrv = RetrievalServer(uf, itf, k=TOPK, exclude_edges=tr, batch_size=BATCH,
                           quantized=True, device="cpu")
    assert tsrv.quantized and tsrv.items_padded == QUANTIZED_TILE
    ti, ts = tsrv.recommend(flow["req"])

    items_p = np.zeros((QUANTIZED_TILE, D), np.float32)
    items_p[:I] = itf
    q, s = jtp.row_quantize(jnp.asarray(items_p))
    ex, exc = jdata.padded_user_items(np.arange(U, dtype=np.int32), tr[0].astype(np.int64), tr[1])
    req = flow["req"]
    for st in range(0, N_REQ, BATCH):
        e = min(st + BATCH, N_REQ)
        chunk = np.pad(req[st:e], (0, BATCH - (e - st)))
        mask = np.array(jtp.exclusion_mask(QUANTIZED_TILE, ex[chunk], exc[chunk]))
        mask[:, I:] = 1
        jv, ji = jtp.streaming_mips_topk_int8(uf[chunk], q, s, TOPK, excl_mask=mask,
                                              tile=QUANTIZED_TILE, interpret=True)
        np.testing.assert_array_equal(ti[st:e], np.asarray(ji)[: e - st])
        np.testing.assert_allclose(ts[st:e], np.asarray(jv)[: e - st], rtol=INT8_RTOL, atol=0)
    assert (ti < I).all()


@pytest.mark.parametrize("emb", ["e0", "final"])
def test_get_metrics_matches_jax(flow, emb):
    jcfg, tcfg = jconfigs.LightGCNConfig(num_iterations=K), LightGCNConfig(num_iterations=K)
    a = jpipe.get_metrics(flow["jparams"], jcfg, flow["jd"].val_set,
                          graph_for_final=flow["jd"].train_graph, eval_embeddings=emb, chunk=64)
    b = tpipe.get_metrics(flow["tparams"], tcfg, flow["td"].val_set,
                          graph_for_final=flow["td"].train_graph, eval_embeddings=emb, chunk=64)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_export_artifacts_round_trip(flow, tmp_path):
    cfg = LightGCNConfig(num_recommendations=20)
    out = tpipe.export_artifacts(flow["tparams"], flow["td"], cfg, str(tmp_path / "t"), chunk=64)
    jout = jpipe.export_artifacts(flow["jparams"], flow["jd"],
                                  jconfigs.LightGCNConfig(num_recommendations=20),
                                  str(tmp_path / "j"), chunk=64)
    ue, ie = flow["tparams"].user_emb.numpy(), flow["tparams"].item_emb.numpy()
    scores = ue.astype(np.float64) @ ie.astype(np.float64).T
    _assert_topk_agree(out, np.take_along_axis(scores, out.astype(np.int64), 1),
                       np.asarray(jout), np.take_along_axis(scores, np.asarray(jout, np.int64), 1))
    z = np.load(tmp_path / "t" / "lightgcn_embeddings.npz")
    np.testing.assert_array_equal(z["users_emb_final"], ue)   # E⁰, as in the reference
    np.testing.assert_array_equal(z["items_emb_final"], ie)
    srv = RetrievalServer.from_lightgcn_artifacts(str(tmp_path / "t"), k=5, batch_size=BATCH,
                                                  device="cpu")
    direct = RetrievalServer(ue, ie, k=5, batch_size=BATCH, device="cpu")
    for a, b in zip(srv.recommend(flow["req"]), direct.recommend(flow["req"])):
        np.testing.assert_array_equal(a, b)
