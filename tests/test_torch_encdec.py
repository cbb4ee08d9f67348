"""The ranking stack's training pipeline in the PyTorch port against the JAX
package's ``train/encdec_pipeline.py``: one train step (forward, gradients,
``optax.adam``) from the same params and batch, the eval step's recall and
precision, the ranking metrics, the port of ``tests/test_encdec.py``'s
acceptance floors and failure handling on the port's ``run_pipeline``, and a
checkpoint the JAX pipeline wrote resuming in the port (and back).

Tolerances: Adam moves an entry by about lr·g/(|g| + ε) on its first
step, so an entry whose gradient is near ε = 1e-8 (a cancellation) moves by
an amount that depends on the gradient's last bits: params (order 0.1,
lr 1e-2) agree to rtol 1e-5, atol 1e-5 (1e-3 of lr); the loss to 1e-5 on
the first step and 1e-4 on the second, which starts from those params;
moments to 1e-4 of each leaf's largest entry. Recall and precision are counts of exact id matches over the
same top-k slots: equal to 1e-6; NDCG and MAP sum f32 discounts in another
order: rtol 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_gnn_recommendation_tpu.configs import Config as JConfig
from laplace_gnn_recommendation_tpu.data import link_pred_data as jlpd
from laplace_gnn_recommendation_tpu.data import synthetic as jsynth
from laplace_gnn_recommendation_tpu.models import sage as jsage
from laplace_gnn_recommendation_tpu.ops import metrics as jmetrics
from laplace_gnn_recommendation_tpu.train import checkpoint as jckpt
from laplace_gnn_recommendation_tpu.train import encdec_pipeline as jpipe
from laplace_gnn_recommendation_tpu_torch.configs import Config
from laplace_gnn_recommendation_tpu_torch.constants import NODE_ITEM
from laplace_gnn_recommendation_tpu_torch.data import link_pred_data as tlpd
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
from laplace_gnn_recommendation_tpu_torch.models import sage
from laplace_gnn_recommendation_tpu_torch.ops import metrics as tmetrics
from laplace_gnn_recommendation_tpu_torch.train import encdec_pipeline as tpipe
from laplace_gnn_recommendation_tpu_torch.train.adam import Adam, EmptyState
from laplace_gnn_recommendation_tpu_torch.train.checkpoint import (
    load_latest,
    tree_leaves_with_path,
)


def make_cfg(cls=Config, **kw):
    defaults = dict(
        epochs=2, batch_size=8, num_neighbors=16, n_hop_neighbors=2,
        hidden_layer_size=32, encoder_layer_output_size=16,
        num_gnn_layers=2, num_linear_layers=2, learning_rate=0.01,
        k=6, candidate_pool_size=10, positive_edges_ratio=0.5,
        negative_edges_ratio=2.0, eval_every=1, save_model=False,
        p_dropout_features=0.1, batch_norm=True, seed=5,
    )
    defaults.update(kw)
    return cls(**defaults)


GRAPH = dict(seed=4, num_users=60, num_items=50, avg_degree=6)
quiet = lambda *_: None  # noqa: E731


@pytest.fixture(scope="module")
def data():
    return tlpd.create_link_pred_data(random_hetero_graph(**GRAPH), make_cfg(), device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(agg="add", budget=256 << 20, **kw):
    ckw = dict(p_dropout_features=0.0, conv_agg_type=agg, dense_bytes_budget=budget, **kw)
    jcfg, tcfg = make_cfg(JConfig, **ckw), make_cfg(**ckw)
    jd = jlpd.create_link_pred_data(jsynth.random_hetero_graph(**GRAPH), jcfg)
    td = tlpd.create_link_pred_data(random_hetero_graph(**GRAPH), tcfg, device="cpu")
    js, tjs = jlpd.create_samplers(jcfg, jd, seed=3), tlpd.create_samplers(tcfg, td, seed=3)
    jp, jbn = jsage.init_sage_params(jax.random.PRNGKey(0), jcfg,
                                     jsage.get_feature_info(jd.graph))
    tp, tbn = sage.sage_params_from_jax(_np(jp), _np(jbn), device="cpu")
    return jcfg, tcfg, jd, td, js, tjs, jp, jbn, tp, tbn


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("agg,budget", [("add", 256 << 20), ("mean", 0), ("max", 0)])
def test_train_steps_match_jax(agg, budget, batch_norm):
    """Steps from the same params on the same batches (the samplers give
    identical batches): loss, params, BatchNorm state, Adam moments.

    With BatchNorm in train mode, the last conv layer's ``lin_l`` biases sit
    right before a batch-statistics normalization, which subtracts them out:
    their exact gradient is 0, and what either package computes is rounding
    noise, which Adam scales up to a step of order lr. Those leaves are held
    to a gradient at rounding level instead of to equal values, and the BN
    case takes one step (a second would start from biases that differ by
    that noise); without BatchNorm, two steps and every leaf."""
    jcfg, tcfg, jd, td, js, tjs, jp, jbn, tp, tbn = _pair(agg, budget, batch_norm=batch_norm)
    tx = Adam(tcfg.learning_rate)
    tstate = tx.init(sage.jax_tree(tp))
    jtx = optax.adam(jcfg.learning_rate)
    jstate = jtx.init(jp)
    jstep = jpipe.make_train_step(jcfg, jd, jtx)
    tstep = tpipe.make_train_step(tcfg, td, tx)
    last = len(jp["convs"]) - 1
    noise = {f"['convs']/[{last}]/['{c}']/['lin_l']/['b']" for c in ("item_to_user", "user_to_item")
             } if batch_norm else set()
    steps = 1 if batch_norm else 2
    for i in range(steps):
        jb, tb = js[0].sample_batch(np.arange(8) + 8 * i), tjs[0].sample_batch(np.arange(8) + 8 * i)
        jp, jbn, jstate, jloss = jstep(jp, jbn, jstate, jb, jax.random.PRNGKey(i))
        tp, tbn, tstate, tloss = tstep(tp, tbn, tstate, tb.to("cpu"), None)
        assert abs(float(jloss) - float(tloss)) < (1e-5 if i == 0 else 1e-4)
        grads = dict(tree_leaves_with_path(sage.grad_tree(tp)))
        for k in noise:
            assert float(grads[k].abs().max()) < 1e-6, k
    jleaves = dict(tree_leaves_with_path(_np(jp)))
    for k, v in tree_leaves_with_path(sage.jax_tree(tp)):
        if k not in noise:
            np.testing.assert_allclose(v.detach().numpy(), jleaves[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    for k, v in tree_leaves_with_path(tbn):
        np.testing.assert_allclose(v.numpy(), dict(tree_leaves_with_path(_np(jbn)))[k],
                                   rtol=1e-5, atol=1e-6)
    assert tstate[0].count == int(jstate[0].count) == steps
    assert isinstance(tstate[1], EmptyState)
    for name in ("mu", "nu"):
        jm = dict(tree_leaves_with_path(_np(getattr(jstate[0], name))))
        for k, v in tree_leaves_with_path(getattr(tstate[0], name)):
            if k not in noise:
                np.testing.assert_allclose(v.numpy(), jm[k], rtol=0,
                                           atol=1e-4 * np.abs(jm[k]).max(), err_msg=k)


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": [rng.normal(size=5).astype(
        np.float32)]}
    tp = {"a": torch.from_numpy(params["a"].copy()), "b": [torch.from_numpy(params["b"][0].copy())]}
    jtx, tx = optax.adam(0.05), Adam(0.05)
    js, ts = jtx.init(params), tx.init(tp)
    jp = params
    for step in range(4):
        g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": [rng.normal(size=5).astype(np.float32)]}
        upd, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = tx.update_({"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0])]}, ts, tp)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp["b"][0].numpy(), np.asarray(jp["b"][0]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("agg", ["add", "max"])
def test_eval_step_matches_jax(agg):
    jcfg, tcfg, jd, td, js, tjs, jp, jbn, tp, tbn = _pair(agg)
    jev, tev = jpipe.make_eval_step(jcfg, jd), tpipe.make_eval_step(tcfg, td)
    for split in (1, 2):
        for jb, tb in zip(js[split].epoch_batches(shuffle=False),
                          tjs[split].epoch_batches(shuffle=False)):
            jr, jpr = jev(jp, jbn, jb)
            tr, tpr = tev(tp, tbn, tb)
            assert abs(float(jr) - float(tr)) < 1e-6 and abs(float(jpr) - float(tpr)) < 1e-6
    jm = jpipe.test_with_sampler(jcfg, jp, jbn, jlpd.create_samplers(jcfg, jd, seed=3)[2], jev)
    tm = tpipe.test_with_sampler(tcfg, tp, tbn, tlpd.create_samplers(tcfg, td, seed=3)[2], tev)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 5, 12])
def test_ranking_metrics_match_jax(k):
    rng = np.random.default_rng(k)
    topk = rng.integers(0, 20, (16, k)).astype(np.int32)
    gt = rng.integers(0, 20, (16, 7)).astype(np.int32)
    cnt = rng.integers(0, 8, 16).astype(np.int32)
    mask = rng.random(16) < 0.8
    r_j = jmetrics.topk_hits(topk, gt, cnt)
    r_t = tmetrics.topk_hits(*(torch.from_numpy(x) for x in (topk, gt, cnt)))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    tc = torch.from_numpy(cnt)
    for um in (None, mask):
        tum = None if um is None else torch.from_numpy(um)
        pairs = [
            (tmetrics.recall_precision_at_k(r_t, tc, k, tum),
             jmetrics.recall_precision_at_k(r_j, cnt, k, um)),
            (tmetrics.ndcg_at_k(r_t, tc, k, tum), jmetrics.ndcg_at_k(r_j, cnt, k, um)),
            (tmetrics.map_at_k(r_t, tc, k, tum), jmetrics.map_at_k(r_j, cnt, k, um)),
            (tmetrics.ranking_metrics(*(torch.from_numpy(x) for x in (topk, gt, cnt)), k, tum),
             jmetrics.ranking_metrics(topk, gt, cnt, k, um)),
        ]
        for t, j in pairs:
            np.testing.assert_allclose(np.asarray([float(x) for x in np.atleast_1d(t)]),
                                       np.asarray([float(x) for x in np.atleast_1d(j)]),
                                       rtol=1e-5, atol=1e-6)


# ---- the port of tests/test_encdec.py's pipeline tests ----------------------

def test_acceptance(data):
    stats = tpipe.run_pipeline(make_cfg(epochs=8, eval_every=2), data, log_fn=quiet,
                               device="cpu")
    assert stats.loss < 0.5          # reference floor: loss < 0.5
    assert stats.recall_test > 0.05
    assert stats.precision_test > 0.01
    assert len(stats.loss_curve) == 8 and stats.loss_curve[-1] < stats.loss_curve[0]
    assert all(v == 0 for v in stats.truncations.values())


def test_deterministic(data):
    cfg = make_cfg(epochs=2)
    s1 = tpipe.run_pipeline(cfg, data, log_fn=quiet, randomization=False, device="cpu")
    s2 = tpipe.run_pipeline(cfg, data, log_fn=quiet, randomization=False, device="cpu")
    assert s1.loss == s2.loss and s1.loss_curve == s2.loss_curve
    assert s1.recall_test == s2.recall_test


def test_parallel_workers_train(data):
    stats = tpipe.run_pipeline(make_cfg(epochs=2, num_workers=2), data, log_fn=quiet,
                               device="cpu")
    assert np.isfinite(stats.loss) and np.isfinite(stats.recall_test)


def test_nan_epoch_rolls_back(data, monkeypatch):
    """A poisoned epoch restores copies of the last good state; the live
    tensors are written in place, so the snapshot must survive."""
    cfg = make_cfg(epochs=4, p_dropout_features=0.0)
    real_make = tpipe.make_train_step
    calls = {"n": 0}
    steps_per_epoch = -(-len(data.splits["train"].user_csr.degrees.nonzero()[0]) // cfg.batch_size)

    def poisoned_make(cfg_, data_, tx, mesh=None):
        real_step = real_make(cfg_, data_, tx, mesh)

        def step(params, bn_state, opt_state, batch, gen):
            p, b, o, loss = real_step(params, bn_state, opt_state, batch, gen)
            calls["n"] += 1
            if calls["n"] > 2 * steps_per_epoch:
                with torch.no_grad():   # poison the live tables too
                    next(p.parameters()).fill_(float("nan"))
                loss = loss * float("nan")
            return p, b, o, loss

        return step

    monkeypatch.setattr(tpipe, "make_train_step", poisoned_make)
    logs = []
    stats, params, _ = tpipe.run_pipeline(cfg, data, log_fn=logs.append, return_state=True,
                                          device="cpu")
    assert sum("rolling back" in line for line in logs) == 2
    assert np.isfinite(stats.recall_test)
    assert all(torch.isfinite(p).all() for p in params.parameters())


def test_non_finite_first_epoch_raises(data, monkeypatch):
    real_make = tpipe.make_train_step

    def poisoned_make(cfg_, data_, tx, mesh=None):
        real_step = real_make(cfg_, data_, tx, mesh)
        return lambda *a: (*real_step(*a)[:3], torch.tensor(float("nan")))

    monkeypatch.setattr(tpipe, "make_train_step", poisoned_make)
    with pytest.raises(FloatingPointError):
        tpipe.run_pipeline(make_cfg(epochs=1), data, log_fn=quiet, device="cpu")


def test_probe_shrinks_and_trains_clean():
    import dataclasses as dc

    g = random_hetero_graph(seed=2, num_users=1000, num_items=2000, avg_degree=5)
    cfg = Config(epochs=2, batch_size=16, num_neighbors=8, n_hop_neighbors=2, k=4,
                 candidate_pool_size=8, eval_every=1, hidden_layer_size=8,
                 encoder_layer_output_size=8)
    d = tlpd.create_link_pred_data(g, cfg, device="cpu")
    b0 = tlpd.create_samplers(cfg, d, seed=0)[0].budgets
    probed = dc.replace(cfg, budget_probe=4)
    b1 = tlpd.create_samplers(probed, d, seed=0)[0].budgets
    assert b1.num_item_slots < b0.num_item_slots and b1.num_edges <= b0.num_edges
    assert b1.labels_per_user == b0.labels_per_user
    stats = tpipe.run_pipeline(probed, d, log_fn=quiet, device="cpu")
    assert np.isfinite(stats.loss)
    assert stats.truncations and all(v == 0 for v in stats.truncations.values())


@pytest.mark.parametrize("variant", ["float", "extra"])
def test_pipeline_end_to_end_variants(variant):
    if variant == "float":
        g = random_hetero_graph(seed=5, num_users=40, num_items=30, avg_degree=5)
        g.node_features_float[NODE_ITEM] = np.random.default_rng(0).normal(
            size=(30, 16)).astype(np.float32)
    else:
        g = random_hetero_graph(**GRAPH, num_extra=5)
    cfg = make_cfg(epochs=2, p_dropout_features=0.0, heterogeneous_prop_agg_type="mean")
    d = tlpd.create_link_pred_data(g, cfg, device="cpu")
    stats = tpipe.run_pipeline(cfg, d, log_fn=quiet, device="cpu")
    assert np.isfinite(stats.loss) and np.isfinite(stats.recall_test)


# ---- checkpoints across packages --------------------------------------------

def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The JAX pipeline writes model_000/model_001 (params, bn state,
    optax.adam state, epoch); the port's resume loads every leaf of the
    newest and continues at epoch 2; the JAX loader reads the port's files."""
    model_dir = str(tmp_path)
    jcfg = make_cfg(JConfig, epochs=2, save_model=True, save_every=0.5, p_dropout_features=0.0)
    jd = jlpd.create_link_pred_data(jsynth.random_hetero_graph(**GRAPH), jcfg)
    _, jp, jbn = jpipe.run_pipeline(jcfg, jd, model_dir=model_dir, log_fn=quiet,
                                    return_state=True)
    assert sorted(os.listdir(model_dir)) == ["model_000.npz", "model_001.npz"]

    tcfg = make_cfg(epochs=3, save_model=True, save_every=0.5, p_dropout_features=0.0)
    td = tlpd.create_link_pred_data(random_hetero_graph(**GRAPH), tcfg, device="cpu")
    tp, tbn = sage.init_sage_params(tcfg, sage.get_feature_info(td.graph), device="cpu")
    template = tpipe._state(tp, tbn, Adam(0.01).init(sage.jax_tree(tp)), 0)
    state, ver = load_latest(model_dir, template)
    assert ver == 1 and state["epoch"] == 1 and state["opt_state"][0].count > 0
    jleaves = dict(tree_leaves_with_path(_np(jp)))
    for k, v in tree_leaves_with_path(state["params"]):
        np.testing.assert_array_equal(v.numpy(), jleaves[k])

    logs = []
    stats = tpipe.run_pipeline(tcfg, td, model_dir=model_dir, log_fn=logs.append, resume=True,
                               device="cpu")
    assert any("Resuming from checkpoint (epoch 2)" in line for line in logs)
    assert len(stats.loss_curve) == 1 and np.isfinite(stats.loss)
    assert "model_002.npz" in os.listdir(model_dir)

    # and back: the JAX loader reads what the port wrote
    jtemplate = {"params": jp, "bn_state": jbn, "opt_state": optax.adam(0.01).init(jp),
                 "epoch": np.zeros((), np.int64)}
    jstate, jver = jckpt.load_latest(model_dir, jtemplate)
    assert jver == 2 and int(jstate["epoch"]) == 2
    assert int(jstate["opt_state"][0].count) == int(state["opt_state"][0].count) + len(
        list(tlpd.create_samplers(tcfg, td)[0].epoch_user_chunks(shuffle=False)))


def test_save_on_inflection_writes_model_final(data, tmp_path, monkeypatch):
    """A drop in val precision saves ``model_final``, which ``load_latest``
    ranks above every numbered checkpoint."""
    vals = iter([(0.5, 0.5), (0.4, 0.3), (0.6, 0.6)])
    real = tpipe.test_with_sampler

    def fake(cfg, params, bn_state, sampler, eval_step, break_at=None, device=None):
        if sampler.train is False and sampler.matchers is data.matchers["val"]:
            return next(vals)
        return real(cfg, params, bn_state, sampler, eval_step, break_at, device)

    monkeypatch.setattr(tpipe, "test_with_sampler", fake)
    cfg = make_cfg(epochs=4, save_model=True, save_every=1.0)
    tpipe.run_pipeline(cfg, data, model_dir=str(tmp_path), log_fn=quiet, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["model_000.npz", "model_final.npz"]
