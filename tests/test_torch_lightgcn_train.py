"""LightGCN training through the PyTorch port, end to end on the CPU: the
ports of ``tests/test_lightgcn.py``'s training tests with the JAX floors,
run on ``device="cpu"`` (the kernel wrappers' plain versions).

The JAX tests run ``propagation="auto"``, which takes the dense tier at
this size; the port has no dense tier yet, so these pin ``"pallas"``
(kernel A's operand, trained through the self-adjoint Functions) or
``"plain"`` (ordinary autograd), as each test says.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import create_lightgcn_data
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
from laplace_gnn_recommendation_tpu_torch.models.lightgcn import (
    bpr_loss,
    init_lightgcn,
    lightgcn_forward,
)
from laplace_gnn_recommendation_tpu_torch.train import lightgcn_pipeline
from laplace_gnn_recommendation_tpu_torch.train.adam import StaircaseAdam
from laplace_gnn_recommendation_tpu_torch.train.checkpoint import load_checkpoint

quiet = dict(export=False, log_fn=lambda *_: None, device="cpu")


@pytest.fixture(scope="module")
def tiny_data():
    eu, ei = random_bipartite_edges(seed=11, num_users=120, num_items=80, avg_degree=12)
    return create_lightgcn_data(eu, ei, 120, 80, pad_multiple=64, device="cpu")


@pytest.mark.parametrize("propagation", ["pallas", "plain"])
def test_grads_flow_to_e0(tiny_data, propagation):
    """Training signal must reach the E⁰ tables through the diffusion."""
    cfg = LightGCNConfig(propagation=propagation, hidden_layer_size=8)
    op = lightgcn_pipeline.select_propagation(cfg, tiny_data.train_graph)
    params = init_lightgcn(120, 80, 8, device="cpu")
    p = dataclasses.replace(params, user_emb=params.user_emb.requires_grad_(),
                            item_emb=params.item_emb.requires_grad_())
    uf, u0, itf, it0 = lightgcn_forward(p, op, 2)
    loss = bpr_loss(uf[:16], u0[:16], itf[:16], it0[:16], itf[16:32], it0[16:32], 1e-6)
    gu, gi = torch.autograd.grad(loss, (p.user_emb, p.item_emb))
    assert float(gu.abs().sum()) > 0 and float(gi.abs().sum()) > 0
    # rows beyond the batch's 16 users and 32 items are reached by the diffusion
    assert float(gu[16:].abs().sum()) > 0 and float(gi[32:].abs().sum()) > 0


def test_training_improves(tiny_data):
    cfg = LightGCNConfig(
        epochs=240, hidden_layer_size=16, batch_size=256, num_iterations=2,
        eval_every=80, lr_decay_every=100, learning_rate=1e-2, k=12, seed=42,
        propagation="pallas",
    )
    stats = lightgcn_pipeline.train(cfg, tiny_data, **quiet)
    # canonical BPR starts at ln2≈0.693; training must pull it well down
    assert stats.loss < 0.5
    # random recommendations give recall ≈ k/num_items = 0.15 here
    assert stats.recall_test > 0.15
    assert stats.precision_test > 0.01
    assert len(stats.loss_curve) == 240 and stats.loss_curve[-1] == stats.loss
    assert np.mean(stats.loss_curve[-5:]) < stats.loss_curve[0]


def test_deterministic_given_seed(tiny_data):
    cfg = LightGCNConfig(
        epochs=12, hidden_layer_size=8, batch_size=64, num_iterations=2,
        eval_every=1000, k=12, seed=7, propagation="pallas",
    )
    s1 = lightgcn_pipeline.train(cfg, tiny_data, **quiet)
    s2 = lightgcn_pipeline.train(cfg, tiny_data, **quiet)
    assert s1.loss == s2.loss and s1.loss_curve == s2.loss_curve
    assert s1.recall_test == s2.recall_test
    s3 = lightgcn_pipeline.train(dataclasses.replace(cfg, seed=8), tiny_data, **quiet)
    assert s3.loss_curve != s1.loss_curve


def test_nan_rollback(tiny_data):
    """A diverging run (absurd lr) rolls back to the last finite eval point
    instead of crashing or poisoning the tables."""
    logs = []
    cfg = LightGCNConfig(
        epochs=8, eval_every=2, hidden_layer_size=8, num_iterations=2,
        batch_size=16, learning_rate=1e18, num_recommendations=8, propagation="pallas",
        return_params=True,
    )
    stats = lightgcn_pipeline.train(cfg, tiny_data, export=False, device="cpu",
                                    log_fn=lambda m: logs.append(str(m)))
    assert any("rolled back" in m for m in logs), logs[-4:]
    # the test eval ran on the params of a finite eval point
    assert bool(torch.isfinite(stats.params.user_emb).all())


def test_rollback_restores_a_copy(tiny_data, monkeypatch):
    """The optimizer writes the tables in place, so the snapshot a rollback
    restores must be a copy: after the rollback the params are the ones
    seen at the last finite eval point, not the poisoned live tables."""
    seen = []
    real_eval = lightgcn_pipeline.evaluation

    def recording_evaluation(cfg, params, *a, **k):
        seen.append(params.user_emb.clone())
        return real_eval(cfg, params, *a, **k)

    monkeypatch.setattr(lightgcn_pipeline, "evaluation", recording_evaluation)
    cfg = LightGCNConfig(
        epochs=5, eval_every=2, hidden_layer_size=8, num_iterations=2, batch_size=16,
        learning_rate=1e18, num_recommendations=8, propagation="pallas", return_params=True,
    )
    logs = []
    stats = lightgcn_pipeline.train(cfg, tiny_data, export=False, device="cpu",
                                    log_fn=lambda m: logs.append(str(m)))
    assert sum("rolled back" in m for m in logs) == 2   # at iters 2 and 4
    # val eval at iter 0, then the test eval after both rollbacks
    assert len(seen) == 2 and torch.equal(seen[1], seen[0])
    assert torch.equal(stats.params.user_emb, seen[0])


def test_best_val_selection_keeps_peak(tiny_data):
    """select_best_val reports test metrics from the best-val iterate."""
    cfg = LightGCNConfig(
        epochs=6, eval_every=2, hidden_layer_size=8, num_iterations=2,
        batch_size=16, num_recommendations=8, select_best_val=True,
        return_params=True, propagation="pallas",
    )
    stats = lightgcn_pipeline.train(cfg, tiny_data, **quiet)
    assert stats.params is not None
    assert np.isfinite(stats.loss)


def test_checkpoint_resume(tiny_data, tmp_path):
    """A second train() picks up from the newest checkpoint (params +
    optimizer schedule step) instead of starting over."""
    cfg = LightGCNConfig(
        epochs=6, eval_every=2, hidden_layer_size=8, num_iterations=2,
        batch_size=16, num_recommendations=8, propagation="pallas",
        checkpoint_every=2, artifact_dir=str(tmp_path),
    )
    lightgcn_pipeline.train(cfg, tiny_data, **quiet)
    names = os.listdir(os.path.join(str(tmp_path), "lightgcn_ckpt"))
    assert any(n.startswith("model_4") for n in names), names

    logs = []
    cfg2 = dataclasses.replace(cfg, epochs=8, resume=True)
    stats = lightgcn_pipeline.train(cfg2, tiny_data, export=False, device="cpu",
                                    log_fn=lambda m: logs.append(str(m)))
    assert any("Resuming from checkpoint (iteration 5)" in m for m in logs), logs[:6]
    assert np.isfinite(stats.loss)
    assert len(stats.loss_curve) == 3   # iterations 5, 6 and 7


def test_resume_draws_a_new_stream(tiny_data, tmp_path):
    """After a resume the batches are drawn from a stream of their own:
    the resumed steps do not replay the first run's losses."""
    cfg = LightGCNConfig(
        epochs=8, eval_every=100, hidden_layer_size=8, num_iterations=2,
        batch_size=16, num_recommendations=8, propagation="pallas",
        checkpoint_every=4, artifact_dir=str(tmp_path),
    )
    full = lightgcn_pipeline.train(cfg, tiny_data, **quiet)
    resumed = lightgcn_pipeline.train(dataclasses.replace(cfg, resume=True), tiny_data, **quiet)
    assert len(resumed.loss_curve) == 3 and resumed.loss_curve != full.loss_curve[5:]


def test_no_poisoned_checkpoints(tiny_data, tmp_path):
    """A diverging run never persists non-finite params: every checkpoint
    opportunity either saves a finite state or logs a skip."""
    cfg = LightGCNConfig(
        epochs=8, eval_every=2, hidden_layer_size=8, num_iterations=2,
        batch_size=16, learning_rate=1e18, num_recommendations=8,
        checkpoint_every=1, artifact_dir=str(tmp_path), propagation="pallas",
    )
    logs = []
    lightgcn_pipeline.train(cfg, tiny_data, export=False, device="cpu",
                            log_fn=lambda m: logs.append(str(m)))
    assert any("skipping checkpoint" in m for m in logs), logs[-6:]
    ckpt_dir = os.path.join(str(tmp_path), "lightgcn_ckpt")
    template_p = init_lightgcn(120, 80, 8, device="cpu")
    template = {"params": template_p, "opt_state": StaircaseAdam(1e-3, 1).init(template_p)}
    wrote = 0
    for name in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        state = load_checkpoint(os.path.join(ckpt_dir, name), template)
        for leaf in (state["params"].user_emb, state["params"].item_emb,
                     state["opt_state"][0].nu.user_emb):
            assert bool(torch.isfinite(leaf).all()), name
        wrote += 1
    skips = sum("skipping checkpoint" in m for m in logs)
    assert wrote + skips == 7, (wrote, skips)


def test_final_eval_scores_through_train_graph(tiny_data):
    """eval_embeddings='final' propagates over the TRAIN adjacency
    (leak-free: the eval split's edges are the targets)."""
    cfg = LightGCNConfig(
        epochs=4, eval_every=2, hidden_layer_size=8, num_iterations=2,
        batch_size=16, num_recommendations=8, return_params=True, propagation="plain",
    )
    stats = lightgcn_pipeline.train(cfg, tiny_data, export=False, eval_embeddings="final",
                                    log_fn=lambda *_: None, device="cpu")
    r_train_prop = lightgcn_pipeline.get_metrics(
        stats.params, cfg, tiny_data.test_set,
        graph_for_final=tiny_data.train_graph, eval_embeddings="final",
    )[0]
    r_test_prop = lightgcn_pipeline.get_metrics(
        stats.params, cfg, tiny_data.test_set,
        graph_for_final=tiny_data.test_graph, eval_embeddings="final",
    )[0]
    assert stats.recall_test == pytest.approx(r_train_prop, abs=1e-9)
    assert r_train_prop != pytest.approx(r_test_prop, abs=1e-9)


def test_export_after_training(tiny_data, tmp_path):
    cfg = LightGCNConfig(
        epochs=4, hidden_layer_size=8, batch_size=64, num_iterations=2, eval_every=1000,
        k=12, num_recommendations=16, artifact_dir=str(tmp_path), propagation="pallas",
    )
    lightgcn_pipeline.train(cfg, tiny_data, log_fn=lambda *_: None, device="cpu")
    recs = np.load(tmp_path / "lightgcn_output.npz")["recommendations"]
    assert recs.shape == (120, 16)
    eu, ei = tiny_data.all_edges
    pos = {(int(a), int(b)) for a, b in zip(eu, ei)}
    assert not any((u, int(i)) in pos for u in range(120) for i in recs[u])
