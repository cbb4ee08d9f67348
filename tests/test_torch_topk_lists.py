"""Kernel B's exclusion lists and the retrieval server's route to them.

On the CPU: the list route's plain version against ``mips_topk`` (the
materializing path the server took before) on the same exclusions;
``sorted_exclusions``' layout; the route rule as a function of shapes; the
server's f32 tier with and without the route.

On the card (``requires_cuda``; they skip here; run with
``python -m pytest --noconftest tests/test_torch_topk_lists.py -m requires_cuda``):
kernel B's list route against its plain version at the H&M catalog size,
and its mask route against its list route. This file imports no JAX, so it
runs on the card machine.
"""
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu_torch import serving
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
from laplace_gnn_recommendation_tpu_torch.ops import topk as ttopk
from laplace_gnn_recommendation_tpu_torch.ops import topk_pallas as ttp
from laplace_gnn_recommendation_tpu_torch.serving import RetrievalServer
from laplace_gnn_recommendation_tpu_torch.utils.profiling import tracer

FILL = ttopk.EXCLUDE_FILL
LIST_I, LIST_D = 300, 8


def _gauss(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _list_case(case, b, seed=0):
    """(rows int32 [b, X], counts int32 [b], k): exclusion rows in random
    order, with what ``case`` adds."""
    rng = np.random.default_rng(seed)
    x, k = 12, 6
    ex = np.full((b, x), -1, np.int32)
    cnt = np.zeros(b, np.int32)
    for r in range(b):
        c = int(rng.integers(0, x + 1))
        ex[r, :c], cnt[r] = rng.choice(LIST_I, c, replace=False), c
    if case == "pads":                 # -1 inside the count
        ex[:, 1] = -1
        cnt[:] = np.maximum(cnt, 3)
    elif case == "past_catalog":       # ids at and past the catalog inside the count
        ex[:, 0] = LIST_I + rng.integers(0, 1 << 20, b)
        ex[::2, 2] = LIST_I
        cnt[:] = np.maximum(cnt, 3)
    elif case == "count_below_width":  # ids in slots at or past the count
        ex = rng.permuted(np.tile(np.arange(LIST_I, dtype=np.int32), (b, 1)), axis=1)[:, :x]
        cnt = rng.integers(0, x, b).astype(np.int32)
    elif case == "over_excluded":      # rows with fewer than k eligible items
        k = 9
        ex = np.concatenate([ex, np.full((b, LIST_I), -1, np.int32)], axis=1)
        for r in range(0, b, 2):
            left = int(rng.integers(0, k))          # eligible items, below k
            ex[r, : LIST_I - left] = rng.permutation(LIST_I)[: LIST_I - left]
            cnt[r] = LIST_I - left
    return torch.from_numpy(ex), torch.from_numpy(cnt), k


LIST_CASES = ["plain", "pads", "past_catalog", "count_below_width", "over_excluded"]


def _excluded_sets(ex, cnt, num_items):
    out = []
    for row, c in zip(ex.tolist(), cnt.tolist()):
        out.append(sorted({i for i in row[: max(c, 0)] if 0 <= i < num_items}))
    return out


def _assert_like_mips_topk(v, i, ref_v, ref_i, ex, cnt, num_items):
    """Values bit-equal; ids equal above ``FILL``; at ``FILL`` both answer
    excluded items, the list route's the lowest ids in ascending order."""
    assert torch.equal(v, ref_v)
    real = v > FILL
    assert torch.equal(torch.where(real, i, 0), torch.where(real, ref_i, 0))
    for r, excl in enumerate(_excluded_sets(ex, cnt, num_items)):
        tail = (~real[r]).sum().item()
        if tail:
            assert (v[r, -tail:] == FILL).all()
            assert i[r, -tail:].tolist() == excl[:tail]
            assert set(ref_i[r, -tail:].tolist()) <= set(excl)


def _ascending_inside_count(ex, cnt):
    """``ex`` with each row's first ``count`` slots sorted, pads and ids
    past the catalog kept (so -1 leads and those ids trail), the slots past
    the count left in their order: the layout the list route takes."""
    out = ex.clone()
    for r, c in enumerate(cnt.clamp(0, ex.shape[1]).tolist()):
        out[r, :c] = out[r, :c].sort().values
    return out


@pytest.mark.parametrize("b", [1, 70])
@pytest.mark.parametrize("case", LIST_CASES)
def test_lists_plain_equals_mips_topk(case, b):
    """The list route on rows ascending inside their counts (``mips_topk``
    takes the same exclusions in any order) and on ``sorted_exclusions``'
    rows."""
    ex, cnt, k = _list_case(case, b, seed=b)
    u, it = _gauss(1, b, LIST_D), _gauss(2, LIST_I, LIST_D)
    ref_v, ref_i = ttopk.mips_topk(u, it, k, ex, cnt)
    asc = _ascending_inside_count(ex, cnt)
    for v, i in (ttp.streaming_mips_topk_lists_plain(u, it, k, asc, cnt),
                 ttp.streaming_mips_topk_lists(u, it, k, asc, cnt),
                 ttp.streaming_mips_topk_lists(u, it, k, *ttopk.sorted_exclusions(LIST_I, ex, cnt))):
        assert v.dtype == torch.float32 and i.dtype == torch.int32 and v.shape == (b, k)
        _assert_like_mips_topk(v, i, ref_v, ref_i, ex, cnt, LIST_I)
    if case == "over_excluded":
        assert (ref_v == FILL).any()


@pytest.mark.parametrize("case,refused", [
    ("swap_inside_count", True),
    ("count_past_width", True),
    ("unsorted_past_count", False),
    ("negative_count", False),
])
def test_lists_plain_refuses_unsorted_rows(case, refused):
    """The plain version (and the wrapper on the CPU) raises where a row's
    first ``count`` ids (clamped to [0, X]) are not ascending, the order the
    kernel assumes; slots past the count are never read."""
    ex = torch.tensor([[3, 9, 20, 40], [1, 2, 250, -1]], dtype=torch.int32)
    cnt = torch.tensor([4, 3], dtype=torch.int32)
    if case == "swap_inside_count":
        ex[1, :2] = torch.tensor([2, 1])
    elif case == "count_past_width":
        ex[0, 3], cnt[0] = 5, 9
    elif case == "unsorted_past_count":
        ex[0, 2:], cnt[0] = torch.tensor([40, 7]), 2
    else:
        ex[0], cnt[0] = torch.tensor([9, 3, 40, 20]), -2
    u, it = _gauss(1, 2, LIST_D), _gauss(2, LIST_I, LIST_D)
    for fn in (ttp.streaming_mips_topk_lists_plain, ttp.streaming_mips_topk_lists):
        if refused:
            with pytest.raises(ValueError, match="ascending"):
                fn(u, it, 6, ex, cnt)
        else:
            v, i = fn(u, it, 6, ex, cnt)
            ref_v, ref_i = ttopk.mips_topk(u, it, 6, ex, cnt)
            assert torch.equal(v, ref_v) and torch.equal(i, ref_i)


@pytest.mark.parametrize("case", LIST_CASES)
def test_sorted_exclusions_layout(case):
    """Valid ids ascending in the first ``count`` slots, -1 after; the same
    exclusions as the input in every helper; the caller's tensors untouched."""
    ex, cnt, _ = _list_case(case, 70, seed=3)
    before = ex.clone()
    rows, counts = ttopk.sorted_exclusions(LIST_I, ex, cnt)
    assert torch.equal(ex, before)
    assert rows.dtype == counts.dtype == torch.int32 and rows.shape == ex.shape
    for r, (row, c) in enumerate(zip(rows.tolist(), counts.tolist())):
        assert row[:c] == sorted(row[:c]) and all(0 <= i < LIST_I for i in row[:c])
        assert all(i == -1 for i in row[c:])
    assert torch.equal(ttp.exclusion_mask(LIST_I, rows, counts), ttp.exclusion_mask(LIST_I, ex, cnt))
    assert torch.equal(ttp.exclusion_mask(LIST_I, rows, None), ttp.exclusion_mask(LIST_I, ex, cnt))


def test_route_rule_from_shapes(monkeypatch):
    """The library path on the CPU, past ``STREAMING_MAX_BATCH``, for k past
    ``MAX_K`` or the catalog and where kernel B's block does not fit; kernel
    B otherwise. Nothing but the shapes is read."""
    assert not ttopk.streams_f32("cpu", 256, 104_547, 32, 12)
    asked = []
    monkeypatch.setattr(ttp, "kernel_b_fits", lambda d, k: asked.append((d, k)) or d <= 64)
    assert ttopk.streams_f32("cuda", 256, 104_547, 32, 12)
    assert ttopk.streams_f32("cuda", 1, 3_706, 64, 12)
    assert ttopk.streams_f32("cuda", ttopk.STREAMING_MAX_BATCH, 104_547, 32, ttp.MAX_K)
    assert not ttopk.streams_f32("cuda", ttopk.STREAMING_MAX_BATCH + 1, 104_547, 32, 12)
    assert not ttopk.streams_f32("cuda", 256, 104_547, 32, ttp.MAX_K + 1)
    assert not ttopk.streams_f32("cuda", 256, 10, 32, 12)
    assert not ttopk.streams_f32("cuda", 256, 104_547, 128, 12)
    assert not ttopk.streams_f32("cpu", 256, 104_547, 32, 12)
    assert asked == [(32, 12), (64, 12), (32, ttp.MAX_K), (128, 12)]


# ---- the server ----------------------------------------------------------------

U, I, D, K = 700, 300, 16, 12


def _tables(seed=5, shuffle=False):
    rng = np.random.default_rng(seed)
    ue, ie = rng.normal(size=(U, D)).astype(np.float32), rng.normal(size=(I, D)).astype(np.float32)
    eu, ei = random_bipartite_edges(seed=seed, num_users=U, num_items=I, avg_degree=8)
    order = rng.permutation(len(eu)) if shuffle else np.lexsort((ei, eu))
    return ue, ie, (eu[order], ei[order])


def _request(srv, users, k=None):
    tracer.enable()
    try:
        out = srv.recommend(users, k)
    finally:
        tracer.disable()
    spans, counters = tracer.drain()
    return out, [s.name for s in spans].count("retrieve.batch"), counters


def test_server_sorts_unsorted_rows():
    """Exclusion edges in random order give a table with each row ascending
    and the answers of the same edges in (user, item) order."""
    ue, ie, shuffled = _tables(shuffle=True)
    _, _, ordered = _tables()
    a = RetrievalServer(ue, ie, k=K, exclude_edges=shuffled, batch_size=8, device="cpu")
    b = RetrievalServer(ue, ie, k=K, exclude_edges=ordered, batch_size=8, device="cpu")
    ex = a._ex.numpy()
    assert (np.diff(ex, axis=1)[ex[:, 1:] >= 0] > 0).all()
    assert torch.equal(a._ex, b._ex) and torch.equal(a._exc, b._exc)
    users = np.random.default_rng(1).integers(0, U, 43)
    for x, y in zip(a.recommend(users), b.recommend(users)):
        np.testing.assert_array_equal(x, y)


def test_server_on_the_cpu_takes_the_library_path():
    """On the CPU the f32 tier keeps ``mips_topk``: no batch is streamed,
    and each batch answers as ``mips_topk`` does on its rows."""
    ue, ie, edges = _tables()
    srv = RetrievalServer(ue, ie, k=K, exclude_edges=edges, batch_size=8, device="cpu")
    users = np.random.default_rng(2).integers(0, U, 21)
    (ids, scores), batches, counters = _request(srv, users)
    assert batches == 3 and counters.get("retrieve.streamed_batches", 0) == 0
    ids_ref, vals_ref = [], []
    for s in range(0, 24, 8):
        chunk = torch.from_numpy(np.pad(users, (0, 3))[s:s + 8])
        v, i = ttopk.mips_topk(srv.user_emb[chunk], srv.item_emb, K, srv._ex[chunk],
                               srv._exc[chunk])
        ids_ref.append(i)
        vals_ref.append(v)
    np.testing.assert_array_equal(ids, torch.cat(ids_ref)[:21].numpy())
    np.testing.assert_array_equal(scores, torch.cat(vals_ref)[:21].numpy())


def _no_score_buffers(monkeypatch, kernel_too):
    """Every helper that builds a [B, I] array or its positions raises; on
    the CPU (``kernel_too`` False) the plain version that stands in for the
    kernel keeps its full scores."""
    def refuse(*a, **kw):
        raise AssertionError("the kernel B tier built a per-batch [B, I] array")

    names = [(serving, "exclusion_mask"), (serving, "exclusion_slots"), (serving, "mips_topk")]
    if kernel_too:
        names += [(ttopk, "scores_with_spare"), (ttp, "exclusion_mask")]
    for mod, name in names:
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("dim", [16, 10])
def test_streamed_tier_plumbing(monkeypatch, dim):
    """The kernel B tier's request path, run on the CPU by forcing the rule
    (the wrapper then takes its plain version): each batch gets its slice of
    the gathered rows and counts and the server builds no [B, I] array; the
    answers are the list route's on each batch; one ``streamed_batches`` a
    batch."""
    monkeypatch.setattr(serving, "streams_f32", lambda *a: a[-1] == K)
    ue, ie, edges = _tables()
    ue, ie = ue[:, :dim], ie[:, :dim]
    srv = RetrievalServer(ue, ie, k=K, exclude_edges=edges, batch_size=8, device="cpu")
    users = np.random.default_rng(3).integers(0, U, 21)
    # a request at a k the rule refuses takes the library route
    (ids, _), _, counters = _request(srv, users, K - 3)
    assert counters.get("retrieve.streamed_batches", 0) == 0
    chunk = torch.from_numpy(users)
    _, ref_i = ttopk.mips_topk(srv.user_emb[chunk], srv.item_emb, K - 3, srv._ex[chunk],
                               srv._exc[chunk])
    np.testing.assert_array_equal(ids, ref_i.numpy())
    _no_score_buffers(monkeypatch, kernel_too=False)
    (ids, scores), batches, counters = _request(srv, users)
    assert batches == 3 and counters["retrieve.streamed_batches"] == 3
    chunk = torch.from_numpy(np.pad(users, (0, 3)))
    uu = srv.user_emb[chunk]
    ref_v, ref_i = ttp.streaming_mips_topk_lists_plain(uu, srv.item_emb, K, srv._ex[chunk],
                                                       srv._exc[chunk])
    np.testing.assert_array_equal(ids, ref_i[:21].numpy())
    np.testing.assert_array_equal(scores, ref_v[:21].numpy())
    assert not (ids[:, :, None] == srv._ex.numpy()[users][:, None, :]).any()
    # no exclusions: kernel B without lists
    plain = RetrievalServer(ue, ie, k=K, batch_size=8, device="cpu")
    (ids, scores), _, counters = _request(plain, users)
    assert counters["retrieve.streamed_batches"] == 3
    ref_v, ref_i = ttp.streaming_mips_topk_plain(uu, srv.item_emb, K)
    np.testing.assert_array_equal(ids, ref_i[:21].numpy())
    np.testing.assert_array_equal(scores, ref_v[:21].numpy())


# ---- on the card -------------------------------------------------------------------

H_AND_M_ITEMS = 104_547   # neither a multiple of 16 nor of 512


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def _card_lists(dev, b, i, d, k, gen):
    """Exclusion rows up to X = 300 wide, ascending: H&M-like rows, rows at
    the catalog's split and tile edges, and over-excluded rows (fewer than k
    items left) where the catalog is small enough."""
    x = 300
    _, split_len = ttp._plan("topk_f32", b, i, -(-d // 4) * 4, k, torch.cuda.current_device())
    rng = np.random.default_rng(int(torch.randint(1 << 30, (1,), generator=gen)))
    ex = np.full((b, x), -1, np.int64)
    cnt = np.zeros(b, np.int64)
    edges = sorted({e for s in range(0, i, split_len)
                    for e in (s - 1, s, s + 1, s + 127, s + 128, s + 129) if 0 <= e < i}
                   | {i - 1})
    for r in range(b):
        kind = r % 4
        if kind == 0:       # a customer's purchases
            c = int(rng.integers(0, 60))
            ids = rng.choice(i, c, replace=False)
        elif kind == 1:     # every split and tile edge near a split start
            ids = np.array(edges[:x])
        elif kind == 2 and i - k + 2 <= x:   # over-excluded
            ids = rng.permutation(i)[: i - int(rng.integers(0, k))]
        else:               # a wide row
            ids = rng.choice(i, min(x, i - 1), replace=False)
        ex[r, : len(ids)], cnt[r] = np.sort(ids), len(ids)
    return (torch.from_numpy(ex).to(dev, torch.int32), torch.from_numpy(cnt).to(dev, torch.int32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("i", [H_AND_M_ITEMS, 291])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("k", [1, 12, 40])
def test_kernel_b_lists_against_plain(i, d, k):
    """Scores on an exact grid (the same f32 value in any summation order,
    and many ties): values and ids equal to the plain version's, ties to
    the lower id, over-excluded rows answering their excluded items at
    ``FILL``. Gaussian scores: values within 1e-6 of ‖u‖·max‖i‖ (a bound on
    any score), and each id equal to the plain version's or carrying its
    value to that tolerance (two scores within rounding of each other may
    trade places)."""
    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(1000 * d + k + i)
    b = 256 + 70
    ex, cnt = _card_lists(dev, b, i, d, k, gen)
    u = torch.randint(-1, 2, (b, d), generator=gen).float().to(dev)
    it = (torch.randint(-2, 3, (i, d), generator=gen).float() * 0.25).to(dev)
    v, ids = ttp.streaming_mips_topk_lists(u, it, k, ex, cnt)
    pv, pi = ttp.streaming_mips_topk_lists_plain(u, it, k, ex, cnt)
    assert torch.equal(v, pv) and torch.equal(ids, pi)
    if i < 300:
        assert (v == FILL).any()
    u, it = _gauss(d, b, d).to(dev), _gauss(k, i, d).to(dev)
    v, ids = ttp.streaming_mips_topk_lists(u, it, k, ex, cnt)
    pv, pi = ttp.streaming_mips_topk_lists_plain(u, it, k, ex, cnt)
    torch.cuda.synchronize()
    tol = 1e-6 * u.double().norm(dim=1, keepdim=True) * it.double().norm(dim=1).max()
    assert bool(((v - pv).abs() <= tol).all())
    own = (u.double()[:, None, :] * it.double()[ids.long()]).sum(-1)
    own = torch.where(ttp.exclusion_mask(i, ex, cnt).gather(1, ids.long()) != 0,
                      torch.full_like(own, FILL), own)
    same = ids == pi
    assert bool((same | ((own - pv.double()).abs() <= tol)).all())
    assert float(same.float().mean()) > 0.99


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [32, 64])
def test_mask_route_equals_list_route(d):
    """Where every row has k eligible items above ``FILL``, the mask route
    and the list route score the same items in the same order: their
    outputs are bit-equal. The mask route also equals its plain version on
    the exact grid."""
    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(d)
    b, i, k = 256, H_AND_M_ITEMS, 12
    ex, cnt = _card_lists(dev, b, i, d, k, gen)
    keep = torch.arange(b, device=dev) % 4 != 2      # no over-excluded rows
    ex, cnt = ex[keep].contiguous(), cnt[keep].contiguous()
    u, it = _gauss(d + 1, ex.shape[0], d).to(dev), _gauss(d + 2, i, d).to(dev)
    mask = ttp.exclusion_mask(i, ex, cnt)
    mv, mi = ttp.streaming_mips_topk(u, it, k, mask)
    lv, li = ttp.streaming_mips_topk_lists(u, it, k, ex, cnt)
    assert bool((lv > FILL).all())
    assert torch.equal(mv, lv) and torch.equal(mi, li)
    ug = torch.randint(-1, 2, (ex.shape[0], d), generator=gen).float().to(dev)
    ig = (torch.randint(-2, 3, (i, d), generator=gen).float() * 0.25).to(dev)
    mv, mi = ttp.streaming_mips_topk(ug, ig, k, mask)
    pv, pi = ttp.streaming_mips_topk_plain(ug, ig, k, mask)
    assert torch.equal(mv, pv) and torch.equal(mi, pi)


@pytest.mark.requires_cuda
def test_card_request_builds_no_score_matrix(monkeypatch):
    """A card request on the kernel B tier, with every helper that builds a
    [B, I] array patched to raise: it answers, one ``streamed_batches`` a
    batch, excluded items never returned, values within 1e-6 of ‖u‖·max‖i‖
    of the list route's plain version."""
    dev = _card()
    ue, ie, edges = _tables()
    srv = RetrievalServer(ue, ie, k=K, exclude_edges=edges, batch_size=256, device="cuda")
    _no_score_buffers(monkeypatch, kernel_too=True)
    users = np.random.default_rng(4).permutation(U)[:600]
    (ids, scores), batches, counters = _request(srv, users)
    assert batches == 3 and counters["retrieve.streamed_batches"] == 3
    monkeypatch.undo()   # the plain version builds the full scores
    u = torch.from_numpy(users).to(dev)
    pv, pi = ttp.streaming_mips_topk_lists_plain(srv.user_emb[u], srv.item_emb, K,
                                                 srv._ex[u], srv._exc[u])
    tol = 1e-6 * np.linalg.norm(ue[users], axis=1)[:, None] * np.linalg.norm(ie, axis=1).max()
    assert (np.abs(scores - pv.cpu().numpy()) <= tol).all()
    assert not (ids[:, :, None] == srv._ex.cpu().numpy()[users][:, None, :]).any()
