"""``RetrievalServer.recommend``'s batch loop: the exclusion table gathered on
the device, one upload and one readback a request, no wait in between.

Each tier's answer is held, ids equal and scores bit-equal, against a plain
per-batch loop of the form the server had: the padded chunk's exclusion rows
from the host table, a boolean-index exclusion (or mask) and one top-k per
batch, each batch copied back on its own. On a card the f32 tier answers
with kernel B's list route instead, held against that route's plain version
in the card test. The sharded tier's case runs in
``tests/test_torch_sharded_production.py``'s spawn.

The ``requires_cuda`` test runs on a card (it skips here):
``python -m pytest --noconftest tests/test_torch_serving_loop.py -m requires_cuda``.
"""
import traceback
import warnings

import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import padded_user_items
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
from laplace_gnn_recommendation_tpu_torch.ops.topk import EXCLUDE_FILL
from laplace_gnn_recommendation_tpu_torch.ops.topk_pallas import (
    row_quantize,
    streaming_mips_topk_int8,
    streaming_mips_topk_lists_plain,
)
from laplace_gnn_recommendation_tpu_torch.serving import RetrievalServer
from laplace_gnn_recommendation_tpu_torch.utils.profiling import tracer

U, I, D, K = 1600, 300, 16, 12
# tier → server batch; "quantized_wide" passes STREAMING_MAX_BATCH, so the
# int8 tier takes its materializing path
TIERS = {"f32": 8, "quantized": 8, "quantized_wide": 520}


def _valid_slots(ex, cnt, num_items):
    x = ex.shape[1]
    valid = ((ex >= 0) & (ex < num_items)
             & (torch.arange(x, device=ex.device)[None, :] < cnt[:, None]))
    return valid, torch.arange(ex.shape[0], device=ex.device)[:, None].expand(ex.shape[0], x)


def _old_batch(srv, uvec, ex, exc, k):
    """One batch as the server answered it before: boolean-index exclusions
    on a cloned score matrix (f32, int8 materializing) or mask (kernel C)."""
    n = srv.items_padded
    if srv.quantized:
        if srv.batch_size <= 512:
            valid, rows = _valid_slots(ex, exc, n)
            mask = torch.zeros((uvec.shape[0], n), dtype=torch.int8, device=uvec.device)
            mask[rows[valid], ex[valid].long()] = 1
            mask[:, srv.num_items:] = 1
            return streaming_mips_topk_int8(uvec, srv._q_items, srv._item_scales, k, mask)
        qu, su = row_quantize(uvec)
        raw = qu.to(torch.float64) @ srv._q_items.to(torch.float64).T
        scores = raw.to(torch.float32) * su.reshape(-1, 1) * srv._item_scales.reshape(1, -1)
        tail = torch.arange(srv.num_items, n, dtype=torch.int32, device=uvec.device)
        ex = torch.cat([tail[None, :].expand(uvec.shape[0], -1), ex], dim=1)
        exc = exc + tail.shape[0]
    else:
        scores = uvec @ srv.item_emb.T
    valid, rows = _valid_slots(ex, exc, n)
    scores = scores.clone()
    scores[rows[valid], ex[valid].long()] = EXCLUDE_FILL
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx.to(torch.int32)


def old_recommend(srv, users, ex_host, exc_host, k):
    """The plain per-batch loop: host exclusion rows uploaded a batch, each
    batch's answer copied back before the next."""
    b, n = srv.batch_size, len(users)
    ids, scores = np.zeros((n, k), np.int32), np.zeros((n, k), np.float32)
    for s in range(0, n, b):
        e = min(s + b, n)
        chunk = np.pad(users[s:e], (0, b - (e - s)))
        uvec = srv.user_emb[torch.from_numpy(chunk).to(srv.device)]
        ex = torch.from_numpy(ex_host[chunk]).to(srv.device)
        exc = torch.from_numpy(exc_host[chunk]).to(srv.device)
        vals, idx = _old_batch(srv, uvec, ex, exc, k)
        ids[s:e], scores[s:e] = idx.cpu().numpy()[: e - s], vals.cpu().numpy()[: e - s]
    return ids, scores


def _tables(num_users, num_items, seed, grid=False):
    """Gaussian tables, or with ``grid`` users in {-1, 0, 1} and items in
    quarters of [-0.5, 0.5]: every score then is the same f32 value in any
    summation order, and many are tied."""
    rng = np.random.default_rng(seed)
    edges = random_bipartite_edges(seed=seed, num_users=num_users, num_items=num_items,
                                   avg_degree=8)
    if grid:
        return (rng.integers(-1, 2, (num_users, D)).astype(np.float32),
                (rng.integers(-2, 3, (num_items, D)) * 0.25).astype(np.float32), edges)
    return (rng.normal(size=(num_users, D)).astype(np.float32),
            rng.normal(size=(num_items, D)).astype(np.float32), edges)


@pytest.fixture(scope="module")
def tables():
    return _tables(U, I, 5)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("size", ["1", "B-1", "B", "B+1", "3B+5"])
@pytest.mark.parametrize("k", [K, K - 3])   # the server's k, and a request's own
def test_recommend_equals_per_batch_loop(tables, tier, size, k):
    ue, ie, edges = tables
    b = TIERS[tier]
    n = {"1": 1, "B-1": b - 1, "B": b, "B+1": b + 1, "3B+5": 3 * b + 5}[size]
    srv = RetrievalServer(ue, ie, k=K, exclude_edges=edges, batch_size=b,
                          quantized=tier != "f32", device="cpu")
    ex_host, exc_host = padded_user_items(np.arange(U, dtype=np.int32),
                                          edges[0].astype(np.int64), edges[1])
    # the server holds each row's ids in ascending order, -1 after
    big = np.iinfo(np.int32).max
    ex_sorted = np.sort(np.where(ex_host < 0, big, ex_host), axis=1)
    np.testing.assert_array_equal(srv._ex.numpy(), np.where(ex_sorted == big, -1, ex_sorted))
    np.testing.assert_array_equal(srv._exc.numpy(), exc_host)
    users = np.random.default_rng(n).integers(0, U, n)
    users[0] = int(np.argmax(exc_host))   # the widest exclusion row
    ids, scores = srv.recommend(users, k)
    ref_ids, ref_scores = old_recommend(srv, users, ex_host, exc_host, k)
    assert ids.dtype == np.int32 and scores.dtype == np.float32 and ids.shape == (n, k)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(scores.view(np.int32), ref_scores.view(np.int32))
    assert (ids < I).all()
    assert not (ids[:, :, None] == ex_host[users][:, None, :]).any()


def test_empty_request(tables):
    ue, ie, edges = tables
    ids, scores = RetrievalServer(ue, ie, k=K, exclude_edges=edges, batch_size=8,
                                  device="cpu").recommend([])
    assert ids.shape == scores.shape == (0, K)
    assert ids.dtype == np.int32 and scores.dtype == np.float32


# ---- on the card -----------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("tier", ["f32", "quantized"])
def test_batch_loop_never_waits_on_the_card(tier):
    """A request of 8 batches under ``set_sync_debug_mode("warn")``: at most
    two synchronising calls, both inside the readback, and
    ``retrieve.host_waits`` counts them. The quantized tier (kernel C)
    answers as the plain per-batch loop does on the card, bit for bit. The
    f32 tier answers every batch with kernel B's list route
    (``retrieve.streamed_batches`` counts 8), whose summation order is not
    the library product's: its answer is held against the list route's
    plain version on tables whose scores are exact in any order (ids equal,
    ties to the lower id; values within 1e-6 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    ue, ie, edges = _tables(4096, 3000, 6, grid=tier == "f32")
    srv = RetrievalServer(ue, ie, k=K, exclude_edges=edges, batch_size=256,
                          quantized=tier == "quantized", device="cuda")
    users = np.random.default_rng(7).permutation(4096)[: 8 * 256]
    srv.recommend(users)   # warm: allocator, cuBLAS handle, pinned blocks
    torch.cuda.synchronize()

    # the warnings raised inside recommend, each with whether it was inside
    # the readback (set_sync_debug_mode may warn on its own)
    in_recommend, in_readback, syncs = [False], [False], []
    real_readback = srv._readback

    def readback(*a):
        in_readback[0] = True
        try:
            return real_readback(*a)
        finally:
            in_readback[0] = False

    srv._readback = readback

    def record(message, category, *a, **kw):
        if in_recommend[0] and "synchroniz" in str(message):
            # where it was called from, for the failure message
            frames = [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
                      for f in traceback.extract_stack()[:-1] if "site-packages" not in f.filename]
            syncs.append((in_readback[0], str(message)[:80], frames[-3:]))

    tracer.enable()
    prior = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            in_recommend[0] = True
            try:
                ids, scores = srv.recommend(users)
            finally:
                in_recommend[0] = False
                torch.cuda.set_sync_debug_mode(prior)
    finally:
        tracer.disable()
    spans, counters = tracer.drain()
    assert 1 <= len(syncs) <= 2 and all(inside for inside, _, _ in syncs), syncs
    assert counters["retrieve.host_waits"] == len(syncs)
    assert [s.name for s in spans].count("retrieve.batch") == 8
    assert counters.get("retrieve.streamed_batches", 0) == (8 if tier == "f32" else 0)

    if tier == "f32":
        u = torch.from_numpy(users).to(srv.device)
        ref_scores, ref_ids = streaming_mips_topk_lists_plain(
            srv.user_emb[u], srv.item_emb, K, srv._ex[u], srv._exc[u])
        ref_ids, ref_scores = ref_ids.cpu().numpy(), ref_scores.cpu().numpy()
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_allclose(scores, ref_scores, rtol=1e-6, atol=0)
        return
    ex_host, exc_host = padded_user_items(np.arange(4096, dtype=np.int32),
                                          edges[0].astype(np.int64), edges[1])
    ref_ids, ref_scores = old_recommend(srv, users, ex_host, exc_host, K)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(scores.view(np.int32), ref_scores.view(np.int32))
