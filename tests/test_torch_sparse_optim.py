"""Lazy row-sparse Adam in the PyTorch port: the ports of
``tests/test_sparse_optim.py`` (only touched rows move, torch-SparseAdam lazy
moments, the first step equals dense Adam, the sparse-embedding PinSAGE run)
and ``sparse_rows_adam_update`` against the JAX function on the same inputs
over several steps, 2-D tables and 1-D biases, with pad rows.

Tolerances: the port and XLA round the same f32 expressions (the bias
corrections' powers among them) each their own way: tables, moments to
rtol 1e-6, atol 1e-7 over three steps.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_gnn_recommendation_tpu.train import optim as joptim
from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
from laplace_gnn_recommendation_tpu_torch.data.etl import LinkPredArtifacts
from laplace_gnn_recommendation_tpu_torch.data.pinsage_data import build_pinsage_data
from laplace_gnn_recommendation_tpu_torch.data.splitting import train_test_split_by_time
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
from laplace_gnn_recommendation_tpu_torch.train.optim import (
    init_sparse_adam_state,
    sparse_rows_adam_update,
)
from laplace_gnn_recommendation_tpu_torch.train.pinsage_pipeline import PinSAGEConfig, train


class TestSparseAdam:
    def test_only_touched_rows_change(self):
        table = torch.ones((10, 4))
        before = table.clone()
        state = init_sparse_adam_state(table)
        rows = torch.tensor([2, 5, 0])
        mask = torch.tensor([True, True, False])  # row 0 is a pad: untouched
        new_table, new_state = sparse_rows_adam_update(table, state, rows, mask,
                                                       torch.ones((3, 4)), lr=0.1)
        diff = (new_table - before).abs().sum(1)
        np.testing.assert_array_equal(np.flatnonzero(diff.numpy()), [2, 5])
        mdiff = new_state.m.abs().sum(1)
        np.testing.assert_array_equal(np.flatnonzero(mdiff.numpy()), [2, 5])
        assert new_state.count == 1

    def test_matches_dense_adam_on_touched_rows(self):
        """The first step on a fully touched table equals dense Adam."""
        rng = np.random.default_rng(0)
        table = rng.normal(size=(6, 3)).astype(np.float32)
        grads = rng.normal(size=(6, 3)).astype(np.float32)
        t = torch.from_numpy(table.copy())
        sparse_new, _ = sparse_rows_adam_update(t, init_sparse_adam_state(t), torch.arange(6),
                                                np.ones(6, bool), torch.from_numpy(grads),
                                                lr=0.01)
        tx = optax.adam(0.01)
        updates, _ = tx.update(jnp.asarray(grads), tx.init(jnp.asarray(table)))
        dense_new = optax.apply_updates(jnp.asarray(table), updates)
        np.testing.assert_allclose(sparse_new.numpy(), np.asarray(dense_new), rtol=1e-5,
                                   atol=1e-6)

    def test_lazy_moments(self):
        """Untouched rows' moments do not decay between steps (torch
        SparseAdam's lazy semantics)."""
        table = torch.ones((4, 2))
        state = init_sparse_adam_state(table)
        one = np.array([True])
        g = torch.ones((1, 2))
        table, state = sparse_rows_adam_update(table, state, torch.tensor([0]), one, g, lr=0.1)
        m_row0 = state.m[0].clone()
        table, state = sparse_rows_adam_update(table, state, torch.tensor([3]), one, g, lr=0.1)
        assert torch.equal(state.m[0], m_row0)


@pytest.mark.parametrize("shape", [(12, 4), (12,)])
@pytest.mark.parametrize("mask_on_host", [True, False])
def test_equals_jax_over_steps(shape, mask_on_host):
    rng = np.random.default_rng(7)
    table = rng.normal(size=shape).astype(np.float32)
    t = torch.from_numpy(table.copy())
    ts = init_sparse_adam_state(t)
    jt = jnp.asarray(table)
    js = joptim.init_sparse_adam_state(jt)
    for step in range(3):
        # valid rows unique; pads (row 0, as the sampler pads) masked out
        valid = rng.choice(12, 5, replace=False)
        rows = np.concatenate([valid, np.zeros(3, np.int64)]).astype(np.int32)
        mask = np.arange(8) < 5
        assert len(np.unique(rows[mask])) == mask.sum()
        grads = rng.normal(size=(8,) + shape[1:]).astype(np.float32)
        jt, js = joptim.sparse_rows_adam_update(jt, js, jnp.asarray(rows), jnp.asarray(mask),
                                                jnp.asarray(grads), lr=0.05)
        t, ts = sparse_rows_adam_update(t, ts, torch.from_numpy(rows.astype(np.int64)),
                                        mask if mask_on_host else torch.from_numpy(mask),
                                        torch.from_numpy(grads), lr=0.05)
        assert ts.count == int(js.count) == step + 1
        for got, want in ((t, jt), (ts.m, js.m), (ts.v, js.v)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


class TestSparsePinSAGE:
    def test_trains_and_matches_structure(self):
        g = random_hetero_graph(seed=3, num_users=40, num_items=30, avg_degree=8)
        eu, _ = g.edges[EDGE_KEY]
        tr, va, te = train_test_split_by_time(eu)
        a = LinkPredArtifacts(graph=g, train_mask=tr, val_mask=va, test_mask=te,
                              customer_id_map_forward={}, article_id_map_forward={})
        data = build_pinsage_data(a)
        cfg = PinSAGEConfig(num_epochs=1, batches_per_epoch=20, batch_size=8,
                            hidden_dims=16, lr=3e-3, k=5, sparse_embedding=True)
        out = train(cfg, data, log_fn=lambda *_: None, device="cpu")
        assert np.isfinite(out["loss"])
        assert out["item_embeddings"].shape == (30, 16)
