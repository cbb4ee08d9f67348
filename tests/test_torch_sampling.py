"""BPR sampling of the PyTorch port against the JAX package.

``ops/search.py``: the port's ``lower_bound`` and ``batched_membership``
return the JAX functions' results bit for bit on the same inputs (empty
rows, the last row, targets past a row's end, a ``max_range`` shorter than
a row). ``ops/sampling.py``: the port's pick on the candidates a JAX key
draws equals JAX's ``structured_negative_sampling`` bit for bit; a
structured negative is never a positive unless all 8 rounds were; the
all-positive fallback keeps the last round; ``sample_bpr_batch`` draws real
edges only, with replacement; one generator seed gives one draw stream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from laplace_gnn_recommendation_tpu.ops import sampling as jsampling
from laplace_gnn_recommendation_tpu.ops import search as jsearch
from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
from laplace_gnn_recommendation_tpu_torch.ops import sampling, search
from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import _user_row_ptr


def _csr(seed, rows, cols, max_len):
    """A CSR with empty rows (every third), columns ascending within a row."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, rows)
    lens[::3] = 0
    lens[-1] = max_len   # the last row is full
    cols_list = [np.sort(rng.choice(cols, size=n, replace=False)) for n in lens]
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    sorted_cols = np.concatenate(cols_list).astype(np.int32)
    return row_ptr, sorted_cols


@pytest.mark.parametrize("max_range_cut", [0, 3])
def test_lower_bound_bitwise_matches_jax(max_range_cut):
    row_ptr, cols = _csr(0, 40, 60, 20)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 40, 500).astype(np.int32)
    rows[:3] = 39                                # the last row
    targets = rng.integers(-2, 64, 500).astype(np.int32)   # below, inside, past the end
    lo, hi = row_ptr[rows], row_ptr[rows + 1]
    max_range = 20 - max_range_cut   # a cut bound stops the search early in both packages
    ref = np.asarray(jsearch.lower_bound(jnp.asarray(cols), jnp.asarray(lo), jnp.asarray(hi),
                                         jnp.asarray(targets), max_range))
    out = search.lower_bound(torch.from_numpy(cols), torch.from_numpy(lo), torch.from_numpy(hi),
                             torch.from_numpy(targets), max_range).numpy()
    np.testing.assert_array_equal(out, ref)
    if max_range_cut == 0:
        exact = np.array([l + np.searchsorted(cols[l:h], t) for l, h, t in zip(lo, hi, targets)])
        np.testing.assert_array_equal(out, exact)


def test_batched_membership_bitwise_matches_jax():
    row_ptr, cols = _csr(2, 50, 30, 12)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 50, (64, 1)).astype(np.int32)
    cands = rng.integers(0, 32, (64, 8)).astype(np.int32)
    ref = np.asarray(jsearch.batched_membership(
        jnp.asarray(row_ptr), jnp.asarray(cols), jnp.broadcast_to(jnp.asarray(rows), (64, 8)),
        jnp.asarray(cands), 12))
    out = search.batched_membership(torch.from_numpy(row_ptr), torch.from_numpy(cols),
                                    torch.from_numpy(rows), torch.from_numpy(cands), 12).numpy()
    np.testing.assert_array_equal(out, ref)
    truth = np.array([[c in set(cols[row_ptr[r]:row_ptr[r + 1]]) for c in cr]
                      for r, cr in zip(rows[:, 0], cands)])
    np.testing.assert_array_equal(out, truth)
    assert truth.any() and not truth.all()


def _graph(seed, users=30, items=25, degree=6):
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, users, users * degree),
                                rng.integers(0, items, users * degree)], 1), axis=0)
    return BipartiteGraph.from_edges(pairs[:, 0], pairs[:, 1], users, items,
                                     pad_multiple=64, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_on_jax_candidates_bitwise(seed):
    g = _graph(seed)
    row_ptr = _user_row_ptr(g)
    max_deg = int(g.user_deg.max())
    rng = np.random.default_rng(seed + 10)
    users = rng.integers(0, g.num_users, 300).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jsampling.structured_negative_sampling(
        key, jnp.asarray(users), jnp.asarray(row_ptr.numpy()), jnp.asarray(g.edge_item.numpy()),
        g.num_items, max_deg))
    # the candidates JAX's function draws from this key
    cands = np.array(jax.random.randint(key, (300, 8), 0, g.num_items, dtype=jnp.int32))
    out = sampling.pick_negatives(torch.from_numpy(cands), torch.from_numpy(users), row_ptr,
                                  g.edge_item, max_deg).numpy()
    np.testing.assert_array_equal(out, ref)


def test_all_positive_lanes_keep_the_last_draw():
    # user 0 owns items 0..3; user 1 owns nothing
    g = BipartiteGraph.from_edges(np.zeros(4, np.int32), np.arange(4), 2, 6, device="cpu")
    cands = torch.tensor([[0, 1, 2, 3, 2, 1, 0, 3],    # all positives: the last round
                          [0, 1, 5, 3, 4, 4, 4, 4],    # first non-positive: round 2
                          [3, 3, 3, 3, 3, 3, 3, 3]], dtype=torch.int32)
    users = torch.tensor([0, 0, 1])
    out = sampling.pick_negatives(cands, users, _user_row_ptr(g), g.edge_item, 4)
    assert out.tolist() == [3, 5, 3]


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 10_000), degree=st.integers(1, 12))
def test_structured_negatives_avoid_positives(seed, degree):
    g = _graph(seed, users=20, items=40, degree=degree)
    eu, ei = g.edges_host()
    pos = set(zip(eu.tolist(), ei.tolist()))
    users = torch.from_numpy(np.random.default_rng(seed).integers(0, 20, 200).astype(np.int32))
    gen = torch.Generator().manual_seed(seed)
    cands = sampling.draw_negative_candidates(gen, 200, g.num_items)
    neg = sampling.pick_negatives(cands, users, _user_row_ptr(g), g.edge_item,
                                  int(g.user_deg.max()))
    assert neg.dtype == torch.int32 and bool(((neg >= 0) & (neg < 40)).all())
    for u, n, c in zip(users.tolist(), neg.tolist(), cands.tolist()):
        if all((u, x) in pos for x in c):
            assert n == c[-1]          # every round a positive: the last draw
        else:
            assert (u, n) not in pos and n == next(x for x in c if (u, x) not in pos)
    # the same draw through the one-call form
    again = sampling.structured_negative_sampling(
        torch.Generator().manual_seed(seed), users, _user_row_ptr(g), g.edge_item,
        g.num_items, int(g.user_deg.max()))
    assert torch.equal(again, neg)


def test_sample_bpr_batch_draws_real_edges_only():
    g = _graph(4)
    assert g.num_edges_padded > g.num_edges   # the graph has pad slots
    gen = torch.Generator().manual_seed(0)
    u, pos, neg = sampling.sample_bpr_batch(
        gen, g.edge_user, g.edge_item, g.num_edges, 5000, _user_row_ptr(g), g.edge_item,
        g.num_items, int(g.user_deg.max()))
    eu, ei = g.edges_host()
    real = set(zip(eu.tolist(), ei.tolist()))
    pairs = list(zip(u.tolist(), pos.tolist()))
    assert all(p in real for p in pairs)
    # with replacement: 5000 draws from fewer edges repeat, and reach most edges
    assert len(set(pairs)) < len(pairs) and len(set(pairs)) > 0.9 * len(real)
    assert neg.shape == (5000,) and bool(((neg >= 0) & (neg < g.num_items)).all())


def test_same_seed_same_draws():
    g = _graph(5)
    args = (g.edge_user, g.edge_item, g.num_edges, 256, _user_row_ptr(g), g.edge_item,
            g.num_items, int(g.user_deg.max()))
    a = sampling.sample_bpr_batch(torch.Generator().manual_seed(7), *args)
    b = sampling.sample_bpr_batch(torch.Generator().manual_seed(7), *args)
    c = sampling.sample_bpr_batch(torch.Generator().manual_seed(8), *args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_uniform_negatives_cover_the_catalog():
    out = sampling.uniform_negative_sampling(torch.Generator().manual_seed(0), (4000,), 10)
    assert out.dtype == torch.int32
    assert sorted(set(out.tolist())) == list(range(10))
