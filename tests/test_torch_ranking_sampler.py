"""The ranking stack's host data path in the PyTorch port against the JAX
package: ``HeteroGraph``, ``random_hetero_graph``, the native library, the
matchers, the subgraph sampler, ``parallel_epoch_batches``, the prefetcher
and ``create_samplers``.

Sampling is numpy + the C++ library driven by ``np.random.default_rng``
in both packages, and the port builds its own copy of ``sampler.cpp``, so
for one seed every ``SubgraphBatch`` array must be IDENTICAL to the JAX
package's — in the deterministic oracle mode, the Python random path and the
native path. The ports of ``tests/test_sampler.py``, ``test_native.py`` and
``test_native_assembly.py`` run on the port. Native cases skip without a
C++ toolchain (decided inside the fixture).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu import native as jnative
from laplace_gnn_recommendation_tpu.configs import Config as JConfig
from laplace_gnn_recommendation_tpu.data import graph as jgraph
from laplace_gnn_recommendation_tpu.data import link_pred_data as jlpd
from laplace_gnn_recommendation_tpu.data import matchers as jmatchers
from laplace_gnn_recommendation_tpu.data import sampler as jsampler
from laplace_gnn_recommendation_tpu.data import synthetic as jsynth
from laplace_gnn_recommendation_tpu_torch import native
from laplace_gnn_recommendation_tpu_torch.configs import Config
from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
from laplace_gnn_recommendation_tpu_torch.data import graph as tgraph
from laplace_gnn_recommendation_tpu_torch.data import link_pred_data as tlpd
from laplace_gnn_recommendation_tpu_torch.data.graph import HostCSR
from laplace_gnn_recommendation_tpu_torch.data.matchers import (
    PopularItemsMatcher,
    UsersWithCommonItemsMatcher,
)
from laplace_gnn_recommendation_tpu_torch.data.prefetch import prefetch
from laplace_gnn_recommendation_tpu_torch.data.sampler import (
    SamplerBudgets,
    SubgraphBatch,
    SubgraphSampler,
    derive_budgets,
    parallel_epoch_batches,
)
from laplace_gnn_recommendation_tpu_torch.data.synthetic import (
    manual_dummy_graph,
    random_bipartite_edges,
    random_hetero_graph,
)

FIELDS = [f.name for f in dataclasses.fields(SubgraphBatch)]


@pytest.fixture
def needs_native():
    if not native.available():
        pytest.skip("no C++ toolchain: the native sampler library cannot build")
    if jnative.LIB is None:
        pytest.skip("the JAX package's native library did not build")


def assert_same_batch(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _csr_pair(mod, eu, ei, nu, ni):
    return (mod.HostCSR.from_edges(eu, ei, nu, ni), mod.HostCSR.from_edges(ei, eu, ni, nu))


CFG = dict(batch_size=8, num_neighbors=8, n_hop_neighbors=2, k=6,
           candidate_pool_size=6, negative_edges_ratio=2.0)


# ---- identical batches for one seed -----------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("mode", ["oracle", "python", "native"])
def test_batches_identical_to_jax(request, mode, train):
    if mode == "native":
        request.getfixturevalue("needs_native")
    eu, ei = random_bipartite_edges(seed=3, num_users=80, num_items=60, avg_degree=7)
    out = []
    for mod, cfg_cls, sm, mm in ((jgraph, JConfig, jsampler, jmatchers),
                                 (tgraph, Config, None, None)):
        ucsr, icsr = _csr_pair(mod, eu, ei, 80, 60)
        if sm is None:
            from laplace_gnn_recommendation_tpu_torch.data import matchers as mm
            from laplace_gnn_recommendation_tpu_torch.data import sampler as sm
        matchers = None if train else [mm.UsersWithCommonItemsMatcher(6, ucsr, icsr),
                                       mm.PopularItemsMatcher(4, np.array([5, 1, 9, 2]))]
        s = sm.SubgraphSampler(cfg_cls(**CFG), ucsr, icsr, train=train, matchers=matchers,
                               randomization=mode != "oracle", seed=11,
                               use_native=mode == "native")
        assert (s._native is not None) == (mode == "native")
        out.append([s.sample_batch(np.arange(i, i + 8) % 80, valid_rows=8 - i) for i in range(3)]
                   + list(s.epoch_batches(shuffle=True)))
        out[-1].append(s.truncations)
    *jb, jt = out[0]
    *tb, tt = out[1]
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert_same_batch(a, b)
    assert jt == tt


def test_truncating_path_identical_to_jax():
    eu, ei = random_bipartite_edges(seed=3, num_users=80, num_items=60, avg_degree=7)
    bud = dict(num_user_slots=6, num_item_slots=20, num_edges=40, labels_per_user=8,
               gt_per_user=5)
    batches, truncs = [], []
    for mod, cfg_cls, sm in ((jgraph, JConfig, jsampler),
                             (tgraph, Config, __import__(
                                 "laplace_gnn_recommendation_tpu_torch.data.sampler",
                                 fromlist=["x"]))):
        ucsr, icsr = _csr_pair(mod, eu, ei, 80, 60)
        s = sm.SubgraphSampler(cfg_cls(**CFG), ucsr, icsr, train=True, seed=2,
                               budgets=sm.SamplerBudgets(**bud), use_native=False)
        batches.append(s.sample_batch(np.arange(8)))
        truncs.append(dict(s.truncations))
    assert_same_batch(*batches)
    assert truncs[0] == truncs[1] and truncs[0]["nodes"] > 0


@pytest.mark.parametrize("workers", [1, 3])
def test_parallel_epoch_identical_to_jax(request, workers):
    """Worker clones own seeded streams and batches come out in epoch order,
    so a parallel epoch is the same in both packages."""
    request.getfixturevalue("needs_native")
    eu, ei = random_bipartite_edges(seed=4, num_users=90, num_items=50, avg_degree=6)
    j = jsampler.SubgraphSampler(JConfig(**CFG), *_csr_pair(jgraph, eu, ei, 90, 50),
                                 train=True, seed=5)
    t = SubgraphSampler(Config(**CFG), *_csr_pair(tgraph, eu, ei, 90, 50), train=True, seed=5)
    jb = list(jsampler.parallel_epoch_batches(j, num_workers=workers))
    tb = list(parallel_epoch_batches(t, num_workers=workers))
    assert len(jb) == len(tb) == 12
    for a, b in zip(jb, tb):
        assert_same_batch(a, b)
    assert j.truncations == t.truncations


def test_derive_budgets_equal_jax():
    for kw in (CFG, dict(CFG, max_labels_per_user=5, max_edges_per_batch=99),
               dict(CFG, n_hop_neighbors=1, num_neighbors=3)):
        for deg, nm in ((1, 1), (17, 2), (40, 3)):
            a = jsampler.derive_budgets(JConfig(**kw), deg, nm, num_users=500, num_items=90)
            b = derive_budgets(Config(**kw), deg, nm, num_users=500, num_items=90)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---- hetero graph, generators, matchers -------------------------------------

@pytest.mark.parametrize("num_extra", [0, 4])
def test_random_hetero_graph_identical(num_extra, tmp_path):
    kw = dict(seed=7, num_users=40, num_items=30, avg_degree=5, feature_cardinality=9,
              num_extra=num_extra)
    jg, tg = jsynth.random_hetero_graph(**kw), random_hetero_graph(**kw)
    assert jg.num_nodes == tg.num_nodes
    assert set(map(str, jg.edges)) == set(map(str, tg.edges))
    for t in jg.node_features:
        np.testing.assert_array_equal(jg.node_features[t], tg.node_features[t])
    for et in jg.edges:
        tet = next(k for k in tg.edges if k.as_tuple() == et.as_tuple())
        for x, y in zip(jg.edges[et], tg.edges[tet]):
            np.testing.assert_array_equal(x, y)
    # the npz format is shared: the port reads the JAX file and vice versa
    tg.node_features_float["article"] = np.ones((30, 3), np.float32)
    tgraph.save_hetero_graph(str(tmp_path / "t.npz"), tg)
    back = jgraph.load_hetero_graph(str(tmp_path / "t.npz"))
    jgraph.save_hetero_graph(str(tmp_path / "j.npz"), back)
    again = tgraph.load_hetero_graph(str(tmp_path / "j.npz"))
    assert again.num_nodes == tg.num_nodes
    np.testing.assert_array_equal(again.node_features_float["article"], np.ones((30, 3)))
    ucsr = again.csr(EDGE_KEY)
    np.testing.assert_array_equal(ucsr.cols, jg.csr(next(iter(jg.edges))).cols)


def test_matchers_identical_to_jax(request):
    eu, ei = random_bipartite_edges(seed=9, num_users=40, num_items=30, avg_degree=5)
    jc, tc = _csr_pair(jgraph, eu, ei, 40, 30), _csr_pair(tgraph, eu, ei, 40, 30)
    users = np.arange(40)
    jm = jmatchers.get_matchers("fashion", 7, *jc, popular_items=np.array([3, 1, 2]))
    tm = __import__("laplace_gnn_recommendation_tpu_torch.data.matchers",
                    fromlist=["x"]).get_matchers("fashion", 7, *tc,
                                                 popular_items=np.array([3, 1, 2]))
    assert [type(m).__name__ for m in jm] == [type(m).__name__ for m in tm]
    for a, b in zip(jm, tm):
        for u in users[:10]:
            np.testing.assert_array_equal(a.get_matches(int(u)), b.get_matches(int(u)))
        np.testing.assert_array_equal(np.asarray(a.get_matches_batch(users)),
                                      np.asarray(b.get_matches_batch(users)))


def test_common_items_matcher_python_path():
    g = manual_dummy_graph()
    eu, ei = g.edges[EDGE_KEY]
    m = UsersWithCommonItemsMatcher(50, HostCSR.from_edges(eu, ei, 3, 6),
                                    HostCSR.from_edges(ei, eu, 6, 3))
    # user 2 buys {4,5}; users sharing: item4→{1,2}, item5→{2}
    np.testing.assert_array_equal(m.get_matches(2), [2, 3, 4, 4, 5, 4, 5])


# ---- golden-subgraph oracle (the port of tests/test_sampler.py) -------------

ADJ = {0: [0, 1, 2], 1: [2, 3, 4], 2: [4, 5]}
REV = {0: [0], 1: [0], 2: [0, 1], 3: [1], 4: [1, 2], 5: [2]}


def make_cfg(**kw):
    defaults = dict(batch_size=1, num_neighbors=64, n_hop_neighbors=3,
                    positive_edges_ratio=0.5, negative_edges_ratio=3.0, k=12,
                    candidate_pool_size=20)
    defaults.update(kw)
    return Config(**defaults)


def oracle_subgraph_edges(seed_user: int, n_hop: int):
    explored, queue, edges = {seed_user}, {seed_user}, set()
    for hop in range(n_hop):
        if not queue:
            break
        new_articles = []
        for u in sorted(queue):
            for a in ADJ[u]:
                new_articles.append(a)
                if hop != 0:
                    edges.add((u, a))
        next_users = set()
        for a in new_articles:
            next_users.update(REV[a])
        next_users -= explored
        explored |= queue | next_users
        queue = next_users
    for a in ADJ[seed_user]:
        edges.add((seed_user, a))
    return edges


@pytest.fixture(scope="module")
def manual():
    g = manual_dummy_graph()
    eu, ei = g.edges[EDGE_KEY]
    return HostCSR.from_edges(eu, ei, 3, 6), HostCSR.from_edges(ei, eu, 6, 3)


def _edge_pairs(b):
    em = np.asarray(b.edge_mask)
    uid, iid = np.asarray(b.user_ids), np.asarray(b.item_ids)
    return {(int(uid[s]), int(iid[d]))
            for s, d in zip(np.asarray(b.edge_src)[em], np.asarray(b.edge_dst)[em])}


def test_train_batch_matches_oracle(manual):
    s = SubgraphSampler(make_cfg(), *manual, train=True, randomization=False)
    b = s.sample_batch(np.array([0]))
    lm = b.label_mask[0]
    np.testing.assert_array_equal(b.label_item_global[0][lm], [0, 2, 5])
    np.testing.assert_array_equal(b.label[0][lm], [1, 1, 0])
    assert all(b.user_ids[b.label_src[0][lm]] == 0)
    np.testing.assert_array_equal(b.item_ids[b.label_dst[0][lm]], [0, 2, 5])
    assert _edge_pairs(b) == oracle_subgraph_edges(0, 3)
    np.testing.assert_array_equal(sorted(b.gt_items[0][: int(b.gt_count[0])]), [0, 1, 2])


def test_one_hop_has_only_direct_edges(manual):
    s = SubgraphSampler(make_cfg(n_hop_neighbors=1), *manual, train=True, randomization=False)
    assert _edge_pairs(s.sample_batch(np.array([1]))) == {(1, 2), (1, 3), (1, 4)}


def test_eval_candidates_xor_positives(manual):
    s = SubgraphSampler(make_cfg(), *manual, train=False,
                        matchers=[PopularItemsMatcher(3, np.array([0, 3, 5]))],
                        randomization=False)
    b = s.sample_batch(np.array([0]))
    lm = b.label_mask[0]
    items, labels = b.label_item_global[0][lm], b.label[0][lm]
    np.testing.assert_array_equal(items[:2], [0, 2])
    np.testing.assert_array_equal(labels[:2], [1, 1])
    assert set(items[2:]) == {1, 2, 3, 5} and all(labels[2:] == 0)


def test_multi_user_batch_slots_consistent(manual):
    s = SubgraphSampler(make_cfg(batch_size=3), *manual, train=True, randomization=False)
    b = s.sample_batch(np.array([0, 1, 2]))
    em = b.edge_mask
    assert b.user_mask[b.edge_src[em]].all() and b.item_mask[b.edge_dst[em]].all()
    for row in range(3):
        assert int(b.user_ids[int(b.seed_slots[row])]) == row


def test_epoch_batches_cover_users_and_pad(manual):
    s = SubgraphSampler(make_cfg(batch_size=2), *manual, train=True, randomization=False)
    batches = list(s.epoch_batches(shuffle=False))
    assert len(batches) == 2
    assert not batches[1].label_mask[1].any() and int(batches[1].gt_count[1]) == 0
    assert all(v == 0 for v in s.truncations.values())


def test_random_mode_positives_are_real(manual):
    s = SubgraphSampler(make_cfg(batch_size=3), *manual, train=True, seed=5)
    b = s.sample_batch(np.array([0, 1, 2]))
    for row, u in enumerate([0, 1, 2]):
        pos = b.label_item_global[row][b.label_mask[row] & (b.label[row] == 1)]
        assert set(pos) <= set(ADJ[u])


def test_truncated_nodes_invalidate_labels(manual):
    budgets = SamplerBudgets(num_user_slots=2, num_item_slots=3, num_edges=16,
                             labels_per_user=8, gt_per_user=6)
    s = SubgraphSampler(make_cfg(batch_size=3), *manual, train=True, randomization=False,
                        budgets=budgets)
    b = s.sample_batch(np.array([0, 1, 2]))
    assert s.truncations["nodes"] > 0
    for row in range(3):
        for col in np.flatnonzero(b.label_mask[row]):
            sslot, dslot = int(b.label_src[row, col]), int(b.label_dst[row, col])
            assert b.user_mask[sslot] and b.item_mask[dslot]
            assert b.item_ids[dslot] == int(b.label_item_global[row, col])
    kept = set(b.user_ids[b.user_mask].tolist())
    for row, u in enumerate([0, 1, 2]):
        if u not in kept:
            assert not b.label_mask[row].any() and int(b.gt_count[row]) == 0


# ---- the native library (ports of test_native*.py) --------------------------

@pytest.fixture(scope="module")
def csrs():
    eu, ei = random_bipartite_edges(seed=3, num_users=100, num_items=80, avg_degree=6)
    return (HostCSR.from_edges(eu, ei, 100, 80), HostCSR.from_edges(ei, eu, 80, 100),
            set(zip(eu.tolist(), ei.tolist())))


def _nhop(ucsr, icsr, nu, ni, seeds, hops, fanout, rng_seed, **kw):
    return native.nhop_sample(ucsr.row_ptr, ucsr.cols, icsr.row_ptr, icsr.cols,
                              nu, ni, np.asarray(seeds), hops, fanout, rng_seed, **kw)


def test_builds_into_its_own_directory(needs_native):
    path = native.library_path()
    port_dir = os.path.dirname(os.path.abspath(native.__file__))
    assert path.startswith(os.path.join(port_dir, "_build") + os.sep) and os.path.exists(path)
    jax_dir = os.path.dirname(os.path.abspath(jnative.__file__))
    assert not path.startswith(jax_dir)


def test_nhop_identical_to_jax(needs_native, csrs):
    ucsr, icsr, _ = csrs
    args = (ucsr.row_ptr, ucsr.cols, icsr.row_ptr, icsr.cols, 100, 80,
            np.arange(20, dtype=np.int32), 3, 5, 42)
    for x, y in zip(jnative.nhop_sample(*args), native.nhop_sample(*args)):
        np.testing.assert_array_equal(x, y)


def test_nhop_edges_are_real_and_exclude_seed(needs_native, csrs):
    ucsr, icsr, real = csrs
    seeds = np.arange(20)
    src, dst, off = _nhop(ucsr, icsr, 100, 80, seeds, 3, 64, 42)
    assert off[-1] == len(src)
    for i, seed in enumerate(seeds):
        for s, d in zip(src[off[i]: off[i + 1]], dst[off[i]: off[i + 1]]):
            assert (int(s), int(d)) in real and int(s) != int(seed)


def test_nhop_matches_python_when_no_cuts(needs_native, csrs):
    ucsr, icsr, _ = csrs
    cfg = Config(batch_size=4, num_neighbors=10_000, n_hop_neighbors=3, k=12)
    s_py = SubgraphSampler(cfg, ucsr, icsr, train=True, use_native=False, seed=0)
    for u in range(6):
        py_src, py_dst = s_py._n_hop_edges(u)
        nat_src, nat_dst, _ = _nhop(ucsr, icsr, 100, 80, [u], 3, 10_000, 5)
        assert set(zip(py_src.tolist(), py_dst.tolist())) == set(
            zip(nat_src.tolist(), nat_dst.tolist()))


def test_nhop_buffer_growth(needs_native, csrs):
    ucsr, icsr, _ = csrs
    src, _, off = _nhop(ucsr, icsr, 100, 80, np.arange(30), 3, 64, 1, max_edges_hint=8)
    assert len(src) == off[-1] > 8


def test_underfill_falls_back_to_exact_scan(needs_native):
    """A hop whose occurrence rejection under-fills tops up to
    ``num_neighbors`` by the exact scan (820 users × 40 articles, all
    connected)."""
    n_u, n_i, fanout = 820, 40, 40
    eu = np.repeat(np.arange(n_u, dtype=np.int64), n_i)
    ei = np.tile(np.arange(n_i, dtype=np.int64), n_u)
    ucsr, icsr = HostCSR.from_edges(eu, ei, n_u, n_i), HostCSR.from_edges(ei, eu, n_i, n_u)
    for rng_seed in (0, 7):
        src, _, off = _nhop(ucsr, icsr, n_u, n_i, [0], 2, fanout, rng_seed)
        hop1 = np.unique(src[off[0]: off[1]])
        assert len(hop1) == fanout and 0 not in hop1


def test_common_items_batch_matches_scalar_and_jax(needs_native, csrs):
    ucsr, icsr, _ = csrs
    m = UsersWithCommonItemsMatcher(6, ucsr, icsr)
    users = np.arange(10)
    batch = m.get_matches_batch(users)
    for row, u in enumerate(users):
        np.testing.assert_array_equal(batch[row][batch[row] >= 0], m.get_matches(int(u)))
    ref = jnative.common_items_matches(ucsr.row_ptr, ucsr.cols, icsr.row_ptr, icsr.cols,
                                       users, 6)
    np.testing.assert_array_equal(batch, ref)


def _assembly_sampler(ucsr, icsr, **kw):
    defaults = dict(batch_size=8, num_neighbors=8, n_hop_neighbors=2, k=6,
                    positive_edges_ratio=0.5, negative_edges_ratio=2.0)
    defaults.update(kw)
    return SubgraphSampler(Config(**defaults), ucsr, icsr, train=True, seed=7)


def test_native_batch_invariants(needs_native):
    eu, ei = random_bipartite_edges(3, 80, 60, 7)
    ucsr, icsr = HostCSR.from_edges(eu, ei, 80, 60), HostCSR.from_edges(ei, eu, 60, 80)
    s = _assembly_sampler(ucsr, icsr)
    assert s._native is not None
    seeds = np.arange(8)
    b = s.sample_batch(seeds)
    assert (np.diff(b.user_ids[b.user_mask]) > 0).all()
    assert (np.diff(b.item_ids[b.item_mask]) > 0).all()
    es, ed = b.edge_src[b.edge_mask], b.edge_dst[b.edge_mask]
    for gu, gi in zip(b.user_ids[es], b.item_ids[ed]):
        assert gi in ucsr.neighbors(int(gu))
    for row, u in enumerate(seeds):
        lm = b.label_mask[row]
        pos = set(ucsr.neighbors(int(u)))
        for item, lab in zip(b.label_item_global[row][lm], b.label[row][lm]):
            assert lab == 0 or item in pos
        assert (b.label_src[row][lm] == b.seed_slots[row]).all()
        g = int(b.gt_count[row])
        np.testing.assert_array_equal(b.gt_items[row, :g], ucsr.neighbors(int(u))[:g])


def test_native_budget_overflow_falls_back(needs_native):
    eu, ei = random_bipartite_edges(3, 80, 60, 7)
    s = _assembly_sampler(HostCSR.from_edges(eu, ei, 80, 60), HostCSR.from_edges(ei, eu, 60, 80))
    s.budgets = SamplerBudgets(num_user_slots=4, num_item_slots=8, num_edges=64,
                               labels_per_user=8, gt_per_user=4)
    b = s.sample_batch(np.arange(8))
    assert s.truncations["nodes"] >= 1 and b.user_mask.sum() <= 4


def test_native_valid_rows_masks_padding(needs_native):
    eu, ei = random_bipartite_edges(3, 80, 60, 7)
    s = _assembly_sampler(HostCSR.from_edges(eu, ei, 80, 60), HostCSR.from_edges(ei, eu, 60, 80))
    b = s.sample_batch(np.array([0, 1, 2, 2, 2, 2, 2, 2]), valid_rows=3)
    assert b.label_mask[3:].sum() == 0 and (b.gt_count[3:] == 0).all()
    assert b.label_mask[:3].sum() > 0


def test_native_eval_matches_python_path(needs_native):
    eu, ei = random_bipartite_edges(0, 40, 30, 5)
    ucsr, icsr = HostCSR.from_edges(eu, ei, 40, 30), HostCSR.from_edges(ei, eu, 30, 40)
    cfg = Config(batch_size=8, num_neighbors=100, n_hop_neighbors=2, k=4, candidate_pool_size=6)
    m = UsersWithCommonItemsMatcher(6, ucsr, icsr)
    mk = lambda nat: SubgraphSampler(cfg, ucsr, icsr, train=False, matchers=[m],  # noqa: E731
                                     seed=3, use_native=nat)
    b_nat, b_py = mk(True).sample_batch(np.arange(8)), mk(False).sample_batch(np.arange(8))

    def negs(b, row):
        return sorted(b.label_item_global[row][b.label_mask[row] & (b.label[row] == 0)].tolist())

    for row in range(8):
        assert negs(b_nat, row) == negs(b_py, row)
    np.testing.assert_array_equal(b_nat.gt_items, b_py.gt_items)
    np.testing.assert_array_equal(b_nat.gt_count, b_py.gt_count)
    assert sorted(_edge_pairs(b_nat)) == sorted(_edge_pairs(b_py))


# ---- device transfer, prefetch, create_samplers -----------------------------

def test_batch_to_device_types():
    eu, ei = random_bipartite_edges(3, 80, 60, 7)
    s = SubgraphSampler(Config(**CFG), HostCSR.from_edges(eu, ei, 80, 60),
                        HostCSR.from_edges(ei, eu, 60, 80), train=True, seed=1, use_native=False)
    b = s.sample_batch(np.arange(8))
    t = b.to("cpu")
    for f in FIELDS:
        x, y = getattr(b, f), getattr(t, f)
        assert isinstance(y, torch.Tensor)
        want = {"i": torch.int64, "u": torch.int64, "b": torch.bool, "f": torch.float32}
        assert y.dtype == want[x.dtype.kind], f
        np.testing.assert_array_equal(y.numpy(), x)
    assert t.to("cpu").edge_src.dtype == torch.int64


def test_prefetch_transform_and_errors():
    assert list(prefetch(iter(range(5)), buffer_size=2, transform=lambda x: x * 10)) == [
        0, 10, 20, 30, 40]

    def bad():
        yield 1
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(prefetch(bad()))


@pytest.mark.parametrize("probe", [0, 3])
def test_create_samplers_identical_to_jax(probe):
    kw = dict(seed=2, num_users=300, num_items=200, avg_degree=5)
    ckw = dict(CFG, budget_probe=probe)
    jd = jlpd.create_link_pred_data(jsynth.random_hetero_graph(**kw), JConfig(**ckw))
    td = tlpd.create_link_pred_data(random_hetero_graph(**kw), Config(**ckw), device="cpu")
    assert td.user_features.dtype == torch.int64 and td.user_features.device.type == "cpu"
    np.testing.assert_array_equal(td.item_features.numpy(), np.asarray(jd.item_features))
    for name in ("train", "val", "test"):
        np.testing.assert_array_equal(td.splits[name].user_csr.cols, jd.splits[name].user_csr.cols)
    js, ts = jlpd.create_samplers(JConfig(**ckw), jd, seed=4), tlpd.create_samplers(
        Config(**ckw), td, seed=4)
    for a, b in zip(js, ts):
        assert dataclasses.asdict(a.budgets) == dataclasses.asdict(b.budgets)
        assert_same_batch(a.sample_batch(np.arange(8)), b.sample_batch(np.arange(8)))


def test_extra_type_carried_like_jax():
    kw = dict(seed=4, num_users=60, num_items=50, avg_degree=6, num_extra=5)
    jd = jlpd.create_link_pred_data(jsynth.random_hetero_graph(**kw), JConfig(**CFG))
    td = tlpd.create_link_pred_data(random_hetero_graph(**kw), Config(**CFG), device="cpu")
    assert td.num_extra == jd.num_extra == 5
    np.testing.assert_array_equal(td.item_extra_ids.numpy(), np.asarray(jd.item_extra_ids))
    np.testing.assert_array_equal(td.extra_features.numpy(), np.asarray(jd.extra_features))
