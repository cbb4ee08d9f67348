"""The dense tier of the PyTorch port against the JAX package's
(``ops/spmm_dense.py``, ``train/lightgcn_pipeline.maybe_dense`` and
``select_propagation``): the ports of ``tests/test_dense_path.py``'s five
tests, the forward and its gradient against the JAX dense tier on the same
inputs, and the tier ``auto`` picks.

Tolerances: against the JAX dense tier both sides form the same bf16
operands and sum exact bf16 products in f32 in another order, so the K-hop
outputs (order 0.1) and the gradients (order 1) agree to atol 1e-6. Against the f32 segment-sum tier, the bf16
rounding of Ã and of each hop's operand allows ~1e-2 relative, the JAX
test's rtol 2e-2, atol 2e-3.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu.data.graph import BipartiteGraph as JGraph
from laplace_gnn_recommendation_tpu.models.lightgcn import LightGCNParams as JParams
from laplace_gnn_recommendation_tpu.models.lightgcn import lightgcn_forward as j_forward
from laplace_gnn_recommendation_tpu.configs import LightGCNConfig as JConfig
from laplace_gnn_recommendation_tpu.ops import spmm_blocked as jsb
from laplace_gnn_recommendation_tpu.ops import spmm_dense as jsd
from laplace_gnn_recommendation_tpu.train import lightgcn_pipeline as jpipe
from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import create_lightgcn_data
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
from laplace_gnn_recommendation_tpu_torch.models.lightgcn import (
    LightGCNParams,
    init_lightgcn,
    lightgcn_forward,
)
from laplace_gnn_recommendation_tpu_torch.ops import spmm_dense as tsd
from laplace_gnn_recommendation_tpu_torch.ops import spmm_pallas as tsp
from laplace_gnn_recommendation_tpu_torch.ops.spmm_dense import DenseAdjacency, dense_fits
from laplace_gnn_recommendation_tpu_torch.train import lightgcn_pipeline

U, I = 90, 70


@pytest.fixture(scope="module")
def graphs():
    eu, ei = random_bipartite_edges(seed=5, num_users=U, num_items=I, avg_degree=7)
    # a duplicated edge: the dense pair must accumulate it, as np.add.at does
    eu, ei = np.append(eu, eu[3]), np.append(ei, ei[3])
    return (JGraph.from_edges(eu, ei, U, I, pad_multiple=64),
            BipartiteGraph.from_edges(eu, ei, U, I, pad_multiple=64, device="cpu"))


def _tables(seed, d):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(U, d)) * 0.1).astype(np.float32),
            (rng.normal(size=(I, d)) * 0.1).astype(np.float32))


def test_dense_fits_budget():
    assert dense_fits(6040, 3706)                  # ML-1M: 90 MB
    assert not dense_fits(1_371_980, 104_547)      # H&M: 574 GB
    for u, i, b in [(6040, 3706, 0), (6040, 3706, 89_544_960), (6040, 3706, 89_544_959)]:
        assert dense_fits(u, i, b) == jsd.dense_fits(u, i, b)
    assert tsd.DENSE_BYTES_BUDGET_DEFAULT == jsd.DENSE_BYTES_BUDGET_DEFAULT


def test_adjacency_equals_jax(graphs):
    jg, tg = graphs
    jd, td = jsd.DenseAdjacency.from_graph(jg), DenseAdjacency.from_graph(tg)
    assert td.a.dtype == torch.bfloat16 and td.a_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(td.a.float().numpy(), np.asarray(jd.a, np.float32))
    np.testing.assert_array_equal(td.a_t.float().numpy(), np.asarray(jd.a_t, np.float32))
    assert (td.num_users, td.num_items) == (U, I)


def test_product_is_f32(graphs):
    """bf16 × bf16 gives an f32 result equal to the product of the upcast
    operands: the tier never keeps a bf16 output."""
    _, tg = graphs
    d = DenseAdjacency.from_graph(tg)
    ue, ie = (torch.from_numpy(x) for x in _tables(0, 16))
    nu, ni = tsd.propagate_dense(d, ue, ie)
    assert nu.dtype == torch.float32 and ni.dtype == torch.float32
    ref = d.a.double() @ ie.to(torch.bfloat16).double()
    np.testing.assert_allclose(nu.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [1, 3])
def test_forward_matches_jax_dense(graphs, k):
    jg, tg = graphs
    ue, ie = _tables(1, 16)
    ref = j_forward(JParams(ue, ie), jsd.DenseAdjacency.from_graph(jg), k)
    out = lightgcn_forward(LightGCNParams(torch.from_numpy(ue), torch.from_numpy(ie)),
                           DenseAdjacency.from_graph(tg), k)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_gradient_matches_jax_dense(graphs):
    """The gradient through the self-adjoint loop Function against
    ``jax.grad`` through the JAX dense tier's custom VJP."""
    jg, tg = graphs
    ue, ie = _tables(2, 8)
    w = np.random.default_rng(3).normal(size=(U + I, 8)).astype(np.float32)
    jd = jsd.DenseAdjacency.from_graph(jg)

    def jloss(u, i):
        uf, _, itf, _ = j_forward(JParams(u, i), jd, 2)
        return jnp.sum(jnp.concatenate([uf, itf]) * w) + jnp.sum(uf[:5] ** 2)

    jgu, jgi = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ue), jnp.asarray(ie))
    u = torch.from_numpy(ue).requires_grad_()
    i = torch.from_numpy(ie).requires_grad_()
    uf, _, itf, _ = lightgcn_forward(LightGCNParams(u, i), DenseAdjacency.from_graph(tg), 2)
    loss = (torch.cat([uf, itf]) * torch.from_numpy(w)).sum() + (uf[:5] ** 2).sum()
    gu, gi = torch.autograd.grad(loss, (u, i))
    np.testing.assert_allclose(gu.numpy(), np.asarray(jgu), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gi.numpy(), np.asarray(jgi), rtol=0, atol=1e-6)


def test_forward_parity(graphs):
    """Dense against the f32 segment-sum tier (the JAX test's bound)."""
    _, tg = graphs
    params = init_lightgcn(U, I, 16, generator=torch.Generator().manual_seed(0), device="cpu")
    d = DenseAdjacency.from_graph(tg)
    uf_s, _, if_s, _ = lightgcn_forward(params, tg, 3)
    uf_d, _, if_d, _ = lightgcn_forward(params, d, 3)
    np.testing.assert_allclose(uf_s.numpy(), uf_d.numpy(), rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(if_s.numpy(), if_d.numpy(), rtol=2e-2, atol=2e-3)


def test_train_step_parity(graphs):
    _, tg = graphs
    cfg = LightGCNConfig(hidden_layer_size=8, num_iterations=2, batch_size=32, k=12)
    max_deg = int(tg.user_deg.max())

    def run(prop):
        p = init_lightgcn(U, I, 8, generator=torch.Generator().manual_seed(1), device="cpu")
        step, tx = lightgcn_pipeline.make_train_step(cfg, tg, max_deg, prop_graph=prop,
                                                     device="cpu")
        _, _, loss = step(p, tx.init(p), torch.Generator().manual_seed(2))
        return float(loss)

    assert abs(run(None) - run(DenseAdjacency.from_graph(tg))) < 1e-3


def test_pipeline_uses_dense_and_trains():
    eu, ei = random_bipartite_edges(seed=12, num_users=120, num_items=80, avg_degree=12)
    data = create_lightgcn_data(eu, ei, 120, 80, pad_multiple=64, device="cpu")
    cfg = LightGCNConfig(
        epochs=60, hidden_layer_size=16, batch_size=256, num_iterations=2,
        eval_every=30, learning_rate=1e-2, k=12, seed=42,
    )
    assert isinstance(lightgcn_pipeline.maybe_dense(cfg, data.train_graph), DenseAdjacency)
    assert isinstance(lightgcn_pipeline.select_propagation(cfg, data.train_graph),
                      DenseAdjacency)
    stats = lightgcn_pipeline.train(cfg, data, export=False, log_fn=lambda *_: None,
                                    device="cpu")
    assert stats.loss < 0.69  # below the ln 2 start


def test_budget_zero_falls_back_to_blocked(graphs):
    _, tg = graphs
    cfg = LightGCNConfig(dense_bytes_budget=0)
    op = lightgcn_pipeline.maybe_dense(cfg, tg)
    assert isinstance(op, tsp.PallasGraph) and not op.gather_bf16


@pytest.mark.parametrize("mode", ["auto", "dense"])
@pytest.mark.parametrize("budget", [None, 0, 89_544_959])
@pytest.mark.parametrize("shape", [(6040, 3706), (1_371_980, 104_547), (600_000, 40)])
def test_select_propagation_tier_matches_jax(monkeypatch, shape, budget, mode):
    """``select_propagation`` returns a ``DenseAdjacency`` exactly where the
    JAX package's does: at ML-1M shape (the default budget and one byte
    short of Ã + Ãᵀ), at H&M shape, and with ``dense_bytes_budget=0``;
    otherwise kernel A in the gather mode of the JAX blocked tier. No
    operand is built: the stub graphs only carry their sizes."""
    users, items = shape
    stub = SimpleNamespace(num_users=users, num_items=items, num_edges=1_000_209,
                           device=torch.device("cpu"))
    for mod, cls in ((jsd, "DenseAdjacency"), (tsd, "DenseAdjacency")):
        monkeypatch.setattr(getattr(mod, cls), "from_graph", staticmethod(lambda g: "dense"))
    monkeypatch.setattr(jsb.BlockedGraph, "from_graph", staticmethod(lambda g: jsb_stub()))
    monkeypatch.setattr(tsp.PallasGraph, "from_graph",
                        staticmethod(lambda g, **kw: ("blocked", kw.get("gather_bf16", False))))
    kw = {} if budget is None else {"dense_bytes_budget": budget}
    jop = jpipe.select_propagation(JConfig(propagation=mode, **kw), stub)
    top = lightgcn_pipeline.select_propagation(LightGCNConfig(propagation=mode, **kw), stub)
    if jop == "dense":
        assert top == "dense"
    else:
        # the JAX blocked operand (a stub here) and its bf16 rule
        assert top == ("blocked", jpipe._maybe_bf16(jsb_stub(), stub).gather_bf16)


@dataclasses.dataclass
class _StubOperand:
    gather_bf16: bool = False


def jsb_stub():
    return _StubOperand()
