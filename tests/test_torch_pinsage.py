"""PinSAGE in the PyTorch port against the JAX package: the sampler's
frontiers, walks, blocks and batches (native and Python paths) equal for one
seed; the model's representations, margin loss and every leaf's gradient
from weights carried across; HITS@k equal on the same embeddings (a tail
chunk shorter than the batch included); the data bundle's arrays equal. Then
the ports of ``tests/test_pinsage.py`` on the port's pipeline, on the CPU
(the PinSAGE case of ``tests/test_synthetic_learnability.py`` is in
``test_torch_pinsage_learning.py``).

Tolerances: the port and JAX sum the same f32 values in other orders (the
sorted segment sums, XLA's reductions), so representations, loss and
gradients agree to 1e-5 of the largest entry of the JAX value (several f32
ulps of a sum of a few hundred terms); the CPU forward of the port against
itself in f64 is held to 1e-5 of the largest entry too.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu.constants import EDGE_KEY as JEDGE_KEY
from laplace_gnn_recommendation_tpu.data import etl as jetl
from laplace_gnn_recommendation_tpu.data import pinsage_data as jpd
from laplace_gnn_recommendation_tpu.data import synthetic as jsynth
from laplace_gnn_recommendation_tpu.data.splitting import train_test_split_by_time as jsplit
from laplace_gnn_recommendation_tpu.models import pinsage as JM
from laplace_gnn_recommendation_tpu.train import pinsage_pipeline as jpipe
from laplace_gnn_recommendation_tpu_torch import native
from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
from laplace_gnn_recommendation_tpu_torch.data.etl import LinkPredArtifacts
from laplace_gnn_recommendation_tpu_torch.data.pinsage_data import (
    PinSAGEBatch,
    PinSAGEBlock,
    PinSAGESampler,
    build_pinsage_data,
)
from laplace_gnn_recommendation_tpu_torch.data.splitting import train_test_split_by_time
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
from laplace_gnn_recommendation_tpu_torch.models import pinsage as M
from laplace_gnn_recommendation_tpu_torch.train.checkpoint import tree_leaves_with_path
from laplace_gnn_recommendation_tpu_torch.train.pinsage_pipeline import (
    PinSAGEConfig,
    hits_at_k,
    train,
)

TOL = 1e-5   # of the largest entry of the JAX value
quiet = lambda *_: None  # noqa: E731
GRAPH = dict(seed=9, num_users=40, num_items=30, avg_degree=8)


def _artifacts(g, split, cls, key=EDGE_KEY):
    eu, _ = g.edges[key]
    tr, va, te = split(eu)
    return cls(graph=g, train_mask=tr, val_mask=va, test_mask=te,
               customer_id_map_forward={}, article_id_map_forward={})


@pytest.fixture(scope="module")
def data():
    g = random_hetero_graph(**GRAPH)
    return build_pinsage_data(_artifacts(g, train_test_split_by_time, LinkPredArtifacts))


@pytest.fixture(scope="module")
def jdata():
    g = jsynth.random_hetero_graph(**GRAPH)
    return jpd.build_pinsage_data(_artifacts(g, jsplit, jetl.LinkPredArtifacts, JEDGE_KEY))


@pytest.fixture(scope="module")
def sampler(data):
    return PinSAGESampler(data, batch_size=8, num_neighbors=3, num_layers=2, seed=1,
                          use_native=False)


def _leaves(x):
    if dataclasses.is_dataclass(x):
        return [leaf for f in dataclasses.fields(x) for leaf in _leaves(getattr(x, f.name))]
    if isinstance(x, (list, tuple)):
        return [leaf for y in x for leaf in _leaves(y)]
    return [np.asarray(x)]


def _assert_same_arrays(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- parity ---

def test_build_pinsage_data_equals_jax(data, jdata):
    for name in ("num_users", "num_items"):
        assert getattr(data, name) == getattr(jdata, name)
    for name in ("item_features", "latest_item_per_user"):
        a, b = getattr(data, name), getattr(jdata, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for csr in ("user_csr", "item_csr"):
        for f in ("row_ptr", "cols"):
            np.testing.assert_array_equal(getattr(getattr(data, csr), f),
                                          getattr(getattr(jdata, csr), f))
    for name in ("val_items", "test_items"):
        for a, b in zip(getattr(data, name), getattr(jdata, name)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_native", [False, True])
def test_sampler_equals_jax(data, jdata, use_native):
    if use_native and not native.available():
        pytest.skip("no C++ compiler for the native library")
    kw = dict(batch_size=8, num_neighbors=3, num_layers=2, seed=4, use_native=use_native)
    ts, js = PinSAGESampler(data, **kw), jpd.PinSAGESampler(jdata, **kw)
    assert ts.path == ("native" if use_native else "python")
    assert (js._native is not None) == use_native
    seeds = np.array([0, 3, 7, 11, 29])
    _assert_same_arrays(ts.neighbor_frontier(seeds), js.neighbor_frontier(seeds))
    _assert_same_arrays(ts._walk_step(np.arange(-1, 12)), js._walk_step(np.arange(-1, 12)))
    _assert_same_arrays(ts.sample_item_triples(), js.sample_item_triples())
    _assert_same_arrays(ts.sample_blocks(np.array([3, 7, 11])),
                        js.sample_blocks(np.array([3, 7, 11])))
    for _ in range(3):
        _assert_same_arrays(ts.sample_train_batch(), js.sample_train_batch())


def _jax_batch(b: PinSAGEBatch):
    blocks = [jpd.PinSAGEBlock(**{k: jnp.asarray(v) for k, v in vars(blk).items()})
              for blk in b.blocks]
    return jpd.PinSAGEBatch(blocks=blocks, **{k: jnp.asarray(v) for k, v in vars(b).items()
                                             if k != "blocks"})


def _model_pair(data, float_dim=0, seed=0):
    cards = data.item_features.max(axis=0).tolist()
    jp = JM.init_pinsage_params(jax.random.PRNGKey(seed), data.num_items, cards, 16, 2,
                                float_feature_dim=float_dim)
    jp = jax.tree.map(np.asarray, jp)
    return jp, M.pinsage_params_from_jax(jp, device="cpu")


def _scaled_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("float_dim", [0, 5])
def test_repr_loss_and_grads_equal_jax(data, float_dim):
    rng = np.random.default_rng(3)
    iff = rng.normal(size=(data.num_items, float_dim)).astype(np.float32) if float_dim else None
    jp, tp = _model_pair(data, float_dim)
    s = PinSAGESampler(data, batch_size=8, num_neighbors=3, num_layers=2, seed=2,
                       use_native=False)
    batch = s.sample_train_batch()
    jb = _jax_batch(batch)
    itf = data.item_features
    tb = batch.to("cpu")
    t_itf = torch.from_numpy(itf.astype(np.int64))
    t_iff = None if iff is None else torch.from_numpy(iff)

    h_j = JM.get_repr(jp, jb.blocks, jnp.asarray(itf), None if iff is None else jnp.asarray(iff))
    h_t = M.get_repr(tp, tb.blocks, t_itf, t_iff)
    _scaled_close(h_t.detach().numpy(), h_j)

    loss_j, g_j = jax.value_and_grad(lambda p: JM.margin_loss(
        p, jb, jnp.asarray(itf), None if iff is None else jnp.asarray(iff), train=False))(jp)
    loss_t = M.margin_loss(tp, tb, t_itf, t_iff, train=False)
    loss_t.backward()
    _scaled_close(loss_t.item(), float(loss_j))
    got = dict(tree_leaves_with_path(M.grad_tree(tp)))
    want = {k: v for k, v in tree_leaves_with_path(jax.tree.map(np.asarray, g_j))}
    assert set(got) == set(want)
    assert float(np.abs(want["['bias']"]).sum()) > 0
    for key in want:
        _scaled_close(got[key].numpy(), want[key])


def test_sparse_path_grads_equal_jax(data):
    """The id-row and bias-row gradients the sparse-embedding step takes."""
    jp, tp = _model_pair(data, seed=1)
    s = PinSAGESampler(data, batch_size=8, seed=5, use_native=False)
    batch = s.sample_train_batch()
    jb, tb = _jax_batch(batch), batch.to("cpu")
    src, dst = batch.blocks[0].src_ids, batch.blocks[-1].dst_ids
    itf = data.item_features
    jid, jbias = jnp.asarray(jp["proj"]["id_table"])[src], jnp.asarray(jp["bias"])[dst]
    _, (gid_j, gb_j) = jax.value_and_grad(
        lambda i, b: JM.margin_loss(jp, jb, jnp.asarray(itf), None, train=False,
                                    id_rows=i, bias_rows=b), argnums=(0, 1))(jid, jbias)
    tid = tp.proj.id_table.detach()[torch.from_numpy(src.astype(np.int64))].requires_grad_()
    tbias = tp.bias.detach()[torch.from_numpy(dst.astype(np.int64))].requires_grad_()
    M.margin_loss(tp, tb, torch.from_numpy(itf.astype(np.int64)), None, train=False,
                  id_rows=tid, bias_rows=tbias).backward()
    _scaled_close(tid.grad.numpy(), gid_j)
    _scaled_close(tbias.grad.numpy(), gb_j)


def test_checkpoint_keys_are_jax_keys(data):
    jp, tp = _model_pair(data, float_dim=3)
    want = sorted(k for k, _ in tree_leaves_with_path(jp))
    assert sorted(k for k, _ in tree_leaves_with_path(M.jax_tree(tp))) == want
    back = {k: v.detach().numpy() for k, v in tree_leaves_with_path(M.jax_tree(tp))}
    for k, v in tree_leaves_with_path(jp):
        np.testing.assert_array_equal(back[k], v)


def test_grads_repeat_bit_for_bit(data):
    _, tp = _model_pair(data)
    batch = PinSAGESampler(data, batch_size=8, seed=6, use_native=False).sample_train_batch()
    tb = batch.to("cpu")
    itf = torch.from_numpy(data.item_features.astype(np.int64))
    grads = []
    for _ in range(2):
        for p in tp.parameters():
            p.grad = None
        gen = torch.Generator().manual_seed(3)
        M.margin_loss(tp, tb, itf, None, train=True, generator=gen).backward()
        grads.append(torch.cat([p.grad.flatten() for p in tp.parameters()]))
    assert torch.equal(*grads)


def test_margin_loss_in_f64_agrees(data):
    """The CPU f32 forward against itself in f64 (what the card's check holds
    its own result to)."""
    _, tp = _model_pair(data)
    batch = PinSAGESampler(data, batch_size=8, seed=7, use_native=False).sample_train_batch()
    tb = batch.to("cpu")
    itf = torch.from_numpy(data.item_features.astype(np.int64))
    ref = copy.deepcopy(tp).double()
    h32 = M.get_repr(tp, tb.blocks, itf, None)
    h64 = M.get_repr(ref, tb.blocks, itf, None)
    _scaled_close(h32.detach().numpy(), h64.detach().numpy())


@pytest.mark.parametrize("batch_size", [16, 512])
@pytest.mark.parametrize("split", ["val", "test"])
def test_hits_at_k_equals_jax(data, jdata, batch_size, split):
    rng = np.random.default_rng(1)
    h = rng.normal(size=(data.num_items, 8)).astype(np.float32)
    users = sum(1 for u in range(data.num_users) if len(data.val_items[u]))
    assert users % 16 != 0   # a tail chunk shorter than the batch
    want = jpipe.hits_at_k(jdata, h, 5, split, batch_size=batch_size)
    got = hits_at_k(data, h, 5, split, batch_size=batch_size, device="cpu")
    assert got == want
    capped = hits_at_k(data, h, 5, split, batch_size=batch_size, user_cap=11, device="cpu")
    assert capped == jpipe.hits_at_k(jdata, h, 5, split, batch_size=batch_size, user_cap=11)


# ------------------------------------------------ ports of test_pinsage.py ---

class TestSampler:
    def test_item_triples_valid(self, sampler, data):
        heads, tails, negs = sampler.sample_item_triples()
        assert len(heads) == len(tails) == len(negs)
        assert (tails >= 0).all() and (tails < data.num_items).all()

    def test_frontier_topk_and_weights(self, sampler):
        seeds = np.array([0, 1, 2])
        fs, fd, fw = sampler.neighbor_frontier(seeds)
        assert (fw > 0).all()
        for s in seeds:
            assert (fd == s).sum() <= sampler.num_neighbors
        assert not np.any(fs == fd)  # no self edges

    def test_block_chain_alignment(self, sampler):
        """The outer block's dst layout is the inner block's src layout."""
        blocks, _ = sampler.sample_blocks(np.array([3, 7, 11]))
        assert len(blocks) == 2
        outer, inner = blocks
        np.testing.assert_array_equal(outer.dst_ids, inner.src_ids)
        np.testing.assert_array_equal(outer.dst_mask, inner.src_mask)
        np.testing.assert_array_equal(inner.dst_ids[:3], [3, 7, 11])
        for b in blocks:
            e = b.edge_w > 0
            assert b.src_mask[b.edge_src[e]].all()
            assert b.dst_mask[b.edge_dst[e]].all()

    def test_leak_prevention(self, sampler):
        forbidden = {(0, 1), (1, 0), (0, 2), (2, 0)}
        blocks, _ = sampler.sample_blocks(np.array([0, 1, 2]), forbidden_pairs=forbidden)
        inner = blocks[-1]
        e = inner.edge_w > 0
        for s, d in zip(inner.src_ids[inner.edge_src[e]], inner.dst_ids[inner.edge_dst[e]]):
            assert (int(s), int(d)) not in forbidden

    def test_blocks_move_to_a_device(self, sampler):
        batch = sampler.sample_train_batch()
        moved = batch.to("cpu")
        assert isinstance(moved.blocks[0], PinSAGEBlock)
        assert moved.pos_head.dtype == torch.int64 and moved.pair_mask.dtype == torch.bool
        assert moved.blocks[0].edge_w.dtype == torch.float32
        np.testing.assert_array_equal(moved.blocks[1].src_ids.numpy(), batch.blocks[1].src_ids)

    def test_valid_src_rows_are_unique(self, sampler):
        """The lazy Adam writes each valid row once: the sampler's valid src
        and dst slots hold distinct items."""
        for _ in range(5):
            b = sampler.sample_train_batch()
            for ids, mask in ((b.blocks[0].src_ids, b.blocks[0].src_mask),
                              (b.blocks[-1].dst_ids, b.blocks[-1].dst_mask)):
                valid = ids[mask]
                assert len(np.unique(valid)) == len(valid)


class TestModel:
    def test_repr_shapes_and_norm(self, sampler, data):
        blocks, _ = sampler.sample_blocks(np.arange(5))
        params = M.init_pinsage_params(data.num_items, data.item_features.max(axis=0).tolist(),
                                       16, 2, device="cpu")
        h = M.get_repr(params, [b.to("cpu") for b in blocks],
                       torch.from_numpy(data.item_features.astype(np.int64)), None)
        assert h.shape == (sampler.dst_budget[0], 16)
        assert torch.isfinite(h).all()

    def test_margin_loss_and_grads(self, sampler, data):
        batch = sampler.sample_train_batch().to("cpu")
        params = M.init_pinsage_params(data.num_items, data.item_features.max(axis=0).tolist(),
                                       16, 2, device="cpu")
        loss = M.margin_loss(params, batch, torch.from_numpy(data.item_features.astype(np.int64)),
                             None, train=False)
        loss.backward()
        assert np.isfinite(loss.item())
        assert float(params.proj.id_table.grad.abs().sum()) > 0
        assert float(params.bias.grad.abs().sum()) > 0

    def test_score_pairs_symmetric_bias(self, data):
        params = M.init_pinsage_params(data.num_items, [], 4, 1, device="cpu")
        with torch.no_grad():
            params.bias.copy_(torch.arange(data.num_items, dtype=torch.float32))
        s = M.score_pairs(params, torch.ones((4, 4)), torch.tensor([5, 6, 7, 8]),
                          torch.tensor([0]), torch.tensor([1]))
        assert float(s[0].detach()) == pytest.approx(4.0 + 5 + 6)


class TestPipeline:
    def test_train_improves_hits(self, data):
        cfg = PinSAGEConfig(num_epochs=2, batches_per_epoch=30, batch_size=8,
                            hidden_dims=16, lr=3e-3, k=5, seed=0)
        out = train(cfg, data, log_fn=quiet, device="cpu")
        assert np.isfinite(out["loss"])
        assert out["item_embeddings"].shape == (data.num_items, 16)
        assert 0.0 <= out["test_hits"] <= 1.0

    def test_checkpoint_resume_legs(self, data, tmp_path):
        """Two bounded-epoch calls through ``checkpoint_dir`` cover one
        straight run's epochs; the final leg completes, the resumed leg does
        not replay epoch 0's draws, and a leg resumed past the end trains
        nothing and reports no loss or val HITS."""
        cfg = PinSAGEConfig(num_epochs=2, batches_per_epoch=20, batch_size=8,
                            hidden_dims=16, lr=3e-3, k=5, seed=0)
        d = str(tmp_path / "legs")
        leg1 = train(cfg, data, log_fn=quiet, checkpoint_dir=d, max_epochs_this_run=1,
                     device="cpu")
        assert leg1["completed"] is False and leg1["epochs_done"] == 1
        assert "test_hits" not in leg1
        leg2 = train(cfg, data, log_fn=quiet, checkpoint_dir=d, max_epochs_this_run=1,
                     device="cpu")
        assert leg2["completed"] is True and leg2["epochs_done"] == 2
        assert 0.0 <= leg2["test_hits"] <= 1.0
        a = M.jax_tree(leg1["params"])["proj"]["tables"][0].detach().numpy()
        b = M.jax_tree(leg2["params"])["proj"]["tables"][0].detach().numpy()
        assert not np.allclose(a, b)
        leg3 = train(cfg, data, log_fn=quiet, checkpoint_dir=d, device="cpu")
        assert leg3["completed"] is True and leg3["loss"] is None and leg3["val_hits"] is None
        assert 0.0 <= leg3["test_hits"] <= 1.0
        with pytest.raises(ValueError, match="another configuration"):
            train(PinSAGEConfig(**{**vars(cfg), "lr": 1e-3}), data, log_fn=quiet,
                  checkpoint_dir=d, device="cpu")

    def test_sparse_checkpoint_resume(self, data, tmp_path):
        cfg = PinSAGEConfig(num_epochs=2, batches_per_epoch=10, batch_size=8, hidden_dims=16,
                            lr=3e-3, k=5, sparse_embedding=True)
        d = str(tmp_path / "sparse")
        train(cfg, data, log_fn=quiet, checkpoint_dir=d, max_epochs_this_run=1, device="cpu")
        logs = []
        out = train(cfg, data, log_fn=logs.append, checkpoint_dir=d, device="cpu")
        assert any("[resume] from epoch 1" in m for m in logs)
        assert out["completed"] and np.isfinite(out["loss"])

    def test_hits_oracle(self, data):
        """Hits happen iff a user's val item is near their latest item —
        checked against a direct computation."""
        rng = np.random.default_rng(0)
        h = rng.normal(size=(data.num_items, 8)).astype(np.float32)
        got = hits_at_k(data, h, 5, "val", device="cpu")
        users = [u for u in range(data.num_users) if len(data.val_items[u])]
        want = []
        for u in users:
            scores = h[data.latest_item_per_user[u]] @ h.T
            scores[data.user_csr.neighbors(u)] = -np.inf
            topk = np.argsort(-scores)[:5]
            want.append(bool(np.isin(topk, data.val_items[u]).any()))
        assert got == pytest.approx(np.mean(want))

    def test_mesh_is_not_ported(self, data):
        """The mesh path is ported (several ranks: ``tests/
        test_torch_sharded_production.py``); on a one-rank mesh ``train``
        gives the run without one."""
        from laplace_gnn_recommendation_tpu_torch.parallel.mesh import build_mesh

        cfg = PinSAGEConfig(num_epochs=1, batches_per_epoch=2, batch_size=8, hidden_dims=8)
        one = train(cfg, data, log_fn=quiet, device="cpu")
        mesh = train(cfg, data, log_fn=quiet, mesh=build_mesh(device="cpu"))
        assert one["loss"] == mesh["loss"] and one["test_hits"] == mesh["test_hits"]


def test_sorted_sum_into_a_big_table():
    """The gathers' backward into a table with more rows than indices (the
    id table at a batch's slots, pads repeating row 0) sums over the
    indices' distinct values: against ``index_add_`` in f64 (sums in
    another order: 1e-12), the same bits twice, untouched rows exactly 0."""
    from laplace_gnn_recommendation_tpu_torch.ops.sorted_sum import SumPlan

    rng = np.random.default_rng(2)
    idx = torch.from_numpy(np.concatenate([np.zeros(500, np.int64),
                                           rng.integers(0, 10_000, 300)]))
    v = torch.from_numpy(rng.normal(size=(800, 3)))
    plan = SumPlan(idx, 10_000)
    assert plan.rows is not None
    out = plan.sum(v)
    ref = torch.zeros(10_000, 3, dtype=torch.float64).index_add_(0, idx, v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(out, SumPlan(idx, 10_000).sum(v))
    untouched = torch.ones(10_000, dtype=torch.bool)
    untouched[idx] = False
    assert bool((out[untouched] == 0).all())
