"""The port's row-sharded SpMM (``ops/spmm_sharded.py``) against the JAX
package's ``shard_map`` version.

* The per-shard arrays equal the JAX ``ShardedBipartiteGraph``'s bit for bit,
  for 2 and 4 parts.
* One hop, the K-hop mean and the gradient of a loss through one hop, run
  on four spawned gloo ranks (a 1×4 mesh, kernel A's plain version on each
  shard), equal JAX's ``propagate_sharded`` on the 4-wide model axis of the
  8-device CPU mesh within rtol 1e-5 / atol 1e-6 (f32 sums in another
  order), and the port's own unsharded kernel A tier bit for bit (a row's
  edges and their order are the unsharded plan's).

The four ranks run once for the module (one spawn); JAX is imported inside
the tests, so the ranks import only the port.
"""
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
from laplace_gnn_recommendation_tpu_torch.ops.spmm_sharded import ShardedBipartiteGraph

NU, NI, D, K = 96, 64, 16, 3


def _edges():
    return random_bipartite_edges(seed=8, num_users=NU, num_items=NI, avg_degree=6)


def _tables():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(NU, D)).astype(np.float32),
            rng.normal(size=(NI, D)).astype(np.float32))


def _port_graph():
    eu, ei = _edges()
    return BipartiteGraph.from_edges(eu, ei, NU, NI, pad_multiple=32, device="cpu")


def _rank_propagation():
    """On each rank of a 1×4 mesh: one hop, K hops, and the gradient of
    Σ new_u² + Σ new_i² through one hop, as this rank's row blocks."""
    from laplace_gnn_recommendation_tpu_torch.ops.spmm_sharded import (
        lightgcn_propagate_sharded,
        propagate_sharded,
    )
    from laplace_gnn_recommendation_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(1, 4, device="cpu")
    sg = ShardedBipartiteGraph.from_graph(_port_graph(), mesh)
    ue, ie = _tables()
    lo_u, hi_u = mesh.row_range(NU)
    lo_i, hi_i = mesh.row_range(NI)
    u = torch.from_numpy(ue[lo_u:hi_u]).requires_grad_()
    i = torch.from_numpy(ie[lo_i:hi_i]).requires_grad_()
    nu, ni = propagate_sharded(mesh, sg, u, i)
    ((nu ** 2).sum() + (ni ** 2).sum()).backward()
    ku, ki = lightgcn_propagate_sharded(mesh, sg, u.detach(), i.detach(), K)
    return {k: v.detach().numpy() for k, v in dict(
        hop_u=nu, hop_i=ni, k_u=ku, k_i=ki, grad_u=u.grad, grad_i=i.grad).items()}


@pytest.fixture(scope="module")
def port_ranks():
    from laplace_gnn_recommendation_tpu_torch.parallel.spawn import run_ranks

    ranks = run_ranks(_rank_propagation, 4, timeout=300)
    return {k: np.concatenate([r[k] for r in ranks]) for k in ranks[0]}


@pytest.fixture(scope="module")
def jax_results(mesh8):
    import jax
    import jax.numpy as jnp

    from laplace_gnn_recommendation_tpu.data.graph import BipartiteGraph as JGraph
    from laplace_gnn_recommendation_tpu.ops.spmm_sharded import (
        ShardedBipartiteGraph as JSharded,
        lightgcn_propagate_sharded,
        propagate_sharded,
    )
    from laplace_gnn_recommendation_tpu.parallel.mesh import row_sharding

    eu, ei = _edges()
    sg = JSharded.from_graph(JGraph.from_edges(eu, ei, NU, NI, pad_multiple=32), mesh8)
    ue, ie = (jax.device_put(jnp.asarray(x), row_sharding(mesh8)) for x in _tables())
    hop_u, hop_i = propagate_sharded(mesh8, sg, ue, ie)
    k_u, k_i = lightgcn_propagate_sharded(mesh8, sg, ue, ie, K)

    def loss(u, i):
        nu, ni = propagate_sharded(mesh8, sg, u, i)
        return jnp.sum(nu ** 2) + jnp.sum(ni ** 2)

    grad_u, grad_i = jax.grad(loss, argnums=(0, 1))(ue, ie)
    return {k: np.asarray(v) for k, v in dict(
        hop_u=hop_u, hop_i=hop_i, k_u=k_u, k_i=k_i, grad_u=grad_u, grad_i=grad_i).items()}


@pytest.mark.parametrize("model_axis", [2, 4])
def test_partition_arrays_equal_jax(model_axis):
    import jax

    from laplace_gnn_recommendation_tpu.data.graph import BipartiteGraph as JGraph
    from laplace_gnn_recommendation_tpu.ops.spmm_sharded import ShardedBipartiteGraph as JSharded
    from laplace_gnn_recommendation_tpu.parallel.mesh import build_mesh as jbuild

    jmesh = jbuild(8 // model_axis, model_axis, devices=jax.devices()[:8])
    eu, ei = _edges()
    jsg = JSharded.from_graph(JGraph.from_edges(eu, ei, NU, NI, pad_multiple=32), jmesh)
    (ud, us, uw), (idd, ius, iw) = ShardedBipartiteGraph.partitions(_port_graph(), model_axis)
    for mine, theirs in [(ud, jsg.u_edge_user), (us, jsg.u_edge_item), (uw, jsg.u_edge_w),
                         (idd, jsg.i_edge_item), (ius, jsg.i_edge_user), (iw, jsg.i_edge_w)]:
        theirs = np.asarray(theirs)
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, theirs)
    # pad destinations never decrease, and pads weigh nothing
    assert (np.diff(ud, axis=1) >= 0).all() and (np.diff(idd, axis=1) >= 0).all()


def test_rank_keeps_its_own_partition():
    """A rank's ``from_graph`` plans hold row ``p`` of the partitions: that
    shard's real edges, in order, and no pad."""
    from types import SimpleNamespace

    from laplace_gnn_recommendation_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    g = _port_graph()
    (ud, us, uw), (idd, ius, iw) = ShardedBipartiteGraph.partitions(g, 4)
    for p in range(4):
        mesh = SimpleNamespace(shape={DATA_AXIS: 1, MODEL_AXIS: 4}, device=torch.device("cpu"),
                               rank=lambda axis, p=p: p)
        sg = ShardedBipartiteGraph.from_graph(g, mesh)
        for plan, dst, src, w in [(sg.to_user, ud[p], us[p], uw[p]),
                                  (sg.to_item, idd[p], ius[p], iw[p])]:
            n = int(np.count_nonzero(w))
            assert int(plan.row_ptr[-1]) == n
            rows = np.repeat(np.arange(plan.num_rows), np.diff(plan.row_ptr.numpy()))
            np.testing.assert_array_equal(rows, dst[:n])
            np.testing.assert_array_equal(plan.src.numpy(), src[:n])
            np.testing.assert_array_equal(plan.w.numpy(), w[:n])
        assert sg.to_user.num_rows == NU // 4 and sg.to_user_t.num_rows == NI


@pytest.mark.parametrize("what", ["hop", "k"])
def test_forward_matches_jax(port_ranks, jax_results, what):
    for side in ("u", "i"):
        key = f"{what}_{side}"
        np.testing.assert_allclose(port_ranks[key], jax_results[key], rtol=1e-5, atol=1e-6)


def test_gradient_matches_jax(port_ranks, jax_results):
    for key in ("grad_u", "grad_i"):
        np.testing.assert_allclose(port_ranks[key], jax_results[key], rtol=1e-5, atol=1e-6)


def test_sharded_equals_unsharded_kernel_tier_bitwise(port_ranks):
    from laplace_gnn_recommendation_tpu_torch.ops.spmm_pallas import (
        PallasGraph,
        lightgcn_propagate_pallas,
        propagate_pallas,
    )

    pg = PallasGraph.from_graph(_port_graph())
    ue, ie = (torch.from_numpy(x) for x in _tables())
    hop_u, hop_i = propagate_pallas(pg, ue, ie)
    k_u, k_i = lightgcn_propagate_pallas(pg, ue, ie, K)
    np.testing.assert_array_equal(port_ranks["hop_u"], hop_u.numpy())
    np.testing.assert_array_equal(port_ranks["hop_i"], hop_i.numpy())
    np.testing.assert_array_equal(port_ranks["k_u"], k_u.numpy())
    np.testing.assert_array_equal(port_ranks["k_i"], k_i.numpy())
