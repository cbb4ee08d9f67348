"""Top-k retrieval of the PyTorch port against the JAX package.

The port's streaming top-k wrappers (their plain versions on the CPU) are
held against the JAX Pallas kernels in interpret mode, with and without an
exclusion mask, in f32 and int8.

Tolerances: f32 values to rtol=1e-6 (atol=1e-7 for scores near zero), since
the dot products are summed in another order; ids equal as sets per row
(gaussian inputs have no ties). int8: ``row_quantize`` and the top-k ids
bitwise equal — the integer dot products are exact; values to rtol=1e-6,
because XLA's CPU code rounds some dequantized scores one ulp away from
(raw · su) · si, which the port (and its CUDA kernel) computes exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu.ops import topk as jtopk
from laplace_gnn_recommendation_tpu.ops import topk_pallas as jtp
from laplace_gnn_recommendation_tpu_torch.ops import topk as ttopk
from laplace_gnn_recommendation_tpu_torch.ops import topk_pallas as ttp

RTOL, ATOL = 1e-6, 1e-7


def _gauss(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _excl(seed, b, i, x):
    """Padded exclusion lists (-1 pads) and counts, with one slot beyond
    each row's count that must be ignored."""
    rng = np.random.default_rng(seed)
    ex = np.full((b, x), -1, np.int32)
    cnt = rng.integers(0, x, b).astype(np.int32)
    for r in range(b):
        ex[r, : cnt[r] + 1] = rng.choice(i, cnt[r] + 1, replace=False)
    return ex, cnt


def _assert_same_sets(a, b):
    for ra, rb in zip(np.asarray(a), np.asarray(b)):
        assert set(ra.tolist()) == set(rb.tolist())


def test_exclusion_mask_matches_jax():
    ex, cnt = _excl(0, 6, 300, 9)
    ex[2, 0] = 299
    a = np.asarray(jtp.exclusion_mask(300, ex, cnt))
    b = ttp.exclusion_mask(300, torch.from_numpy(ex), torch.from_numpy(cnt)).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        np.asarray(jtp.exclusion_mask(300, ex)),
        ttp.exclusion_mask(300, torch.from_numpy(ex)).numpy(),
    )


@pytest.mark.parametrize("masked", [False, True])
def test_streaming_f32_matches_jax_interpret(masked):
    b, i, d, k = 8, 1024, 32, 12
    u, it = _gauss(1, b, d), _gauss(2, i, d)
    mask = None
    if masked:
        ex, cnt = _excl(3, b, i, 40)
        mask = np.array(jtp.exclusion_mask(i, ex, cnt))
        jv, ji = jtp.streaming_mips_topk_masked(u, it, mask, k, tile=512, interpret=True)
    else:
        jv, ji = jtp.streaming_mips_topk(u, it, k, tile=512, interpret=True)
    tv, ti = ttp.streaming_mips_topk(
        torch.from_numpy(u), torch.from_numpy(it), k,
        None if mask is None else torch.from_numpy(mask),
    )
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    _assert_same_sets(ti, ji)
    if mask is not None:
        assert not np.take_along_axis(mask, ti.numpy().astype(np.int64), 1).any()


def test_streaming_masked_alias_is_the_same_fold():
    u, it = torch.from_numpy(_gauss(4, 3, 8)), torch.from_numpy(_gauss(5, 64, 8))
    mask = torch.zeros((3, 64), dtype=torch.int8)
    mask[:, ::3] = 1
    a = ttp.streaming_mips_topk_masked(u, it, mask, 5)
    b = ttp.streaming_mips_topk(u, it, 5, mask)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_row_quantize_bitwise_matches_jax():
    x = _gauss(6, 50, 32)
    x[3] = 0.0                                   # zero row → scale 0
    x[4, :] = np.linspace(-1.0, 1.0, 32) * 127   # exact .5 ties round to even
    jq, js = jtp.row_quantize(x)
    tq, ts = ttp.row_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.shape == (1, 50)


@pytest.mark.parametrize("masked,d,k", [
    pytest.param(False, 32, 10, id="False"),
    pytest.param(True, 32, 10, id="True"),
    pytest.param(False, 32, 33, id="k33-False"),   # a list of K=64 entries
    pytest.param(True, 32, 33, id="k33-True"),
    pytest.param(False, 20, 12, id="d20-False"),   # the kernel's unaligned paths
    pytest.param(True, 20, 12, id="d20-True"),
])
def test_streaming_int8_bitwise_matches_jax_interpret(masked, d, k):
    b, i = 8, 1024
    u, it = _gauss(7, b, d), _gauss(8, i, d)
    jq, js = jtp.row_quantize(it)
    mask = None
    if masked:
        ex, cnt = _excl(9, b, i, 30)
        mask = np.array(jtp.exclusion_mask(i, ex, cnt))
    jv, ji = jtp.streaming_mips_topk_int8(u, jq, js, k, excl_mask=mask, tile=512, interpret=True)
    tv, ti = ttp.streaming_mips_topk_int8(
        torch.from_numpy(u), torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(js)),
        k, None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("tile", [512, 256])
def test_row_with_fewer_than_k_eligible_items(kind, tile):
    """Unfilled slots hold (NEG_INF, 0). The JAX fold agrees when the
    catalog is one tile; across tiles it refills those slots with the id in
    the first running slot (an extracted candidate keeps its id, with its
    value set to NEG_INF, and the argmax over an all-NEG_INF row picks
    position 0), so the row repeats its best id there. Those slots are ties
    at NEG_INF; the port keeps id 0, and the values agree everywhere."""
    b, i, d, k = 2, 512, 16, 6
    u, it = _gauss(10, b, d), _gauss(11, i, d)
    mask = np.zeros((b, i), np.int8)
    mask[0, :] = 1             # nothing eligible
    mask[1, 3:] = 1            # three eligible items
    if kind == "f32":
        jv, ji = jtp.streaming_mips_topk_masked(u, it, mask, k, tile=tile, interpret=True)
        tv, ti = ttp.streaming_mips_topk(torch.from_numpy(u), torch.from_numpy(it), k,
                                         torch.from_numpy(mask))
    else:
        q, s = jtp.row_quantize(it)
        jv, ji = jtp.streaming_mips_topk_int8(u, q, s, k, excl_mask=mask, tile=tile, interpret=True)
        tv, ti = ttp.streaming_mips_topk_int8(
            torch.from_numpy(u), torch.from_numpy(np.asarray(q)),
            torch.from_numpy(np.asarray(s)), k, torch.from_numpy(mask))
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    assert (tv[0] == ttp.NEG_INF).all() and (ti[0] == 0).all()
    assert (tv[1, 3:] == ttp.NEG_INF).all() and (ti[1, 3:] == 0).all()
    assert sorted(ti[1, :3].tolist()) == [0, 1, 2]
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ti[:, :3], ji[:, :3])
    if tile == i:
        np.testing.assert_array_equal(ti, ji)
    else:
        assert (ji[1, 3:] == ji[1, 0]).all()


def test_ties_go_to_the_lower_id():
    u = torch.ones((1, 4))
    it = torch.zeros((40, 4))
    it[[5, 17, 30]] = 1.0
    it[[9, 2]] = 2.0
    v, i = ttp.streaming_mips_topk(u, it, 6)
    assert i.tolist() == [[2, 9, 5, 17, 30, 0]]
    assert v[0, :5].tolist() == [8.0, 8.0, 4.0, 4.0, 4.0] and v[0, 5].item() == 0.0


def test_k_above_the_kernel_limit_raises():
    with pytest.raises(ValueError, match="k must be"):
        ttp.streaming_mips_topk(torch.zeros((1, 4)), torch.zeros((300, 4)), ttp.MAX_K + 1)


def test_apply_exclusion_keeps_fill_and_neg_inf_apart():
    """The materializing path fills with EXCLUDE_FILL; the streaming fold
    uses NEG_INF — both as in the JAX package."""
    scores = _gauss(12, 4, 50)
    ex, cnt = _excl(13, 4, 50, 6)
    ex[1, -1] = -1
    a = np.asarray(jtopk.apply_exclusion(jnp.asarray(scores), ex, cnt))
    b = ttopk.apply_exclusion(torch.from_numpy(scores), torch.from_numpy(ex),
                              torch.from_numpy(cnt)).numpy()
    np.testing.assert_array_equal(a, b)
    assert (b == ttopk.EXCLUDE_FILL).sum() == cnt.sum() and ttopk.EXCLUDE_FILL == -1024
    mask = ttp.exclusion_mask(50, torch.from_numpy(ex), torch.from_numpy(cnt))
    full = torch.ones_like(mask)
    v, _ = ttp.streaming_mips_topk(torch.ones((4, 3)), torch.ones((50, 3)), 2, full)
    assert (v == ttp.NEG_INF).all() and ttp.NEG_INF != ttopk.EXCLUDE_FILL


@pytest.mark.parametrize("excl", [False, True])
def test_materializing_paths_match_jax(excl):
    b, i, d, k = 5, 300, 16, 7
    u, it = _gauss(14, b, d), _gauss(15, i, d)
    ex, cnt = _excl(16, b, i, 12) if excl else (None, None)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    jv, ji = jtopk.mips_topk(u, it, k, ex, cnt)
    tv, ti = ttopk.mips_topk(torch.from_numpy(u), torch.from_numpy(it), k, t(ex), t(cnt))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    _assert_same_sets(ti, ji)
    q, s = jtp.row_quantize(it)
    jv, ji = jtopk.mips_topk_int8(u, q, s, k, ex, cnt)
    tv, ti = ttopk.mips_topk_int8(torch.from_numpy(u), torch.from_numpy(np.asarray(q)),
                                  torch.from_numpy(np.asarray(s)), k, t(ex), t(cnt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _assert_same_sets(ti, ji)
    jv, ji = jtopk.auto_mips_topk(u, it, k, ex, cnt)
    tv, ti = ttopk.auto_mips_topk(torch.from_numpy(u), torch.from_numpy(it), k, t(ex), t(cnt))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    _assert_same_sets(ti, ji)


def test_auto_dispatch_rule(monkeypatch):
    """The JAX rule with the card in place of the TPU: on the CPU the
    materializing path serves even past the scores budget."""
    calls = []
    monkeypatch.setattr(ttopk, "SCORES_BYTES_BUDGET", 0)
    monkeypatch.setattr(ttp, "streaming_mips_topk", lambda *a, **kw: calls.append(a))
    u, it = torch.from_numpy(_gauss(17, 4, 8)), torch.from_numpy(_gauss(18, 512, 8))
    v, i = ttopk.auto_mips_topk(u, it, 3)
    assert not calls and v.shape == (4, 3) and i.dtype == torch.int32


def _tied(seed, b, i, d):
    """Users in {-1, 0, 1} and items in {-0.5, ..., 0.5} by quarters: every
    score is a multiple of 1/4 that f32 holds exactly in any summation
    order, and most scores are shared by many items."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-1, 2, (b, d)).astype(np.float32)
    it = (rng.integers(-2, 3, (i, d)) * 0.25).astype(np.float32)
    return u, it


@pytest.mark.parametrize("k", [5, 12, 40])
@pytest.mark.parametrize("masked", [False, True])
def test_tied_scores_match_jax_fold(k, masked):
    """On tied scores the port's plain version gives the JAX fold's ids (two
    tiles in interpret mode): value descending, id ascending among ties."""
    b, i, d = 6, 1024, 8
    u, it = _tied(30 + k, b, i, d)
    mask = None
    if masked:
        mask = (np.random.default_rng(31 + k).random((b, i)) < 0.3).astype(np.int8)
        assert ((mask == 0).sum(1) >= k).all()   # at least k eligible items a row
        jv, ji = jtp.streaming_mips_topk_masked(u, it, mask, k, tile=512, interpret=True)
    else:
        jv, ji = jtp.streaming_mips_topk(u, it, k, tile=512, interpret=True)
    tv, ti = ttp.streaming_mips_topk(torch.from_numpy(u), torch.from_numpy(it), k,
                                     None if mask is None else torch.from_numpy(mask))
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    same = tv[:, 1:] == tv[:, :-1]
    assert same.any() and (ti[:, 1:][same] > ti[:, :-1][same]).all()


_PAD_ID = 2 ** 31 - 1


def _better(a, b):
    """The kernels' total order on (value, id) pairs."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _merge_list(lst, buf):
    """csrc/topk_fold.cuh ``merge_list`` in Python: bitonic sort of the 64-entry
    buffer (pads below everything), C[i] = max(L[i], B[K-1-i]) over the
    buffer's best min(K, 64), then a bitonic merge of the K-entry list."""
    k_len = len(lst)
    b = buf + [(ttp.NEG_INF, _PAD_ID)] * (64 - len(buf))
    size = 2
    while size <= 64:
        stride = size // 2
        while stride:
            nb = list(b)
            for e in range(64):
                best_here = ((e & stride) == 0) == ((e & size) == 0)
                o = b[e ^ stride]
                if _better(o, b[e]) if best_here else _better(b[e], o):
                    nb[e] = o
            b, stride = nb, stride // 2
        size *= 2
    c = list(lst)
    for q in range(min(k_len, 64)):
        i = k_len - 1 - q
        if _better(b[q], c[i]):
            c[i] = b[q]
    stride = k_len // 2
    while stride:
        for a in range(k_len):
            if a & stride == 0 and _better(c[a + stride], c[a]):
                c[a], c[a + stride] = c[a + stride], c[a]
        stride //= 2
    return c


def _list_len(k):
    k_len = 32
    while k_len < k:
        k_len *= 2
    return k_len


def _emulate_fold(scores, excluded, k, order, ids=None):
    """The scoring kernels' fold (csrc/topk_fold.cuh) for one user in Python:
    candidates offered in ``order``, a 64-entry buffer merged whenever it is
    full and at the end. Returns the sorted list of K (value, id) pairs;
    ``ids`` maps positions to item ids (default: the positions)."""
    ids = np.arange(len(scores)) if ids is None else ids
    lst, buf = [(ttp.NEG_INF, 0)] * _list_len(k), []
    for j in order:
        cand = (scores[j], int(ids[j]))
        if excluded[j] or not _better(cand, lst[k - 1]):
            continue
        if len(buf) == 64:
            lst, buf = _merge_list(lst, buf), []
            if not _better(cand, lst[k - 1]):
                continue
        buf.append(cand)
    if buf:
        lst = _merge_list(lst, buf)
    return lst


def _emulate_merge(parts, k):
    """``topk_merge_kernel`` for one user: the per-split lists of k entries
    read 32 at a time in split order; a batch of candidates that would
    overflow the 64-entry buffer merges the buffer first."""
    lst, buf = [(ttp.NEG_INF, 0)] * _list_len(k), []
    flat = [e for p in parts for e in p[:k]]
    for c0 in range(0, len(flat), 32):
        cands = [e for e in flat[c0:c0 + 32] if _better(e, lst[k - 1])]
        if cands and len(buf) + len(cands) > 64:
            lst, buf = _merge_list(lst, buf), []
        buf += cands
    if buf:
        lst = _merge_list(lst, buf)
    return lst[:k]


def _fold_case(kind, k):
    """Scores [3, 700] as a kernel forms them, the exclusions, and the plain
    version's (values, ids). f32: scores on an exact grid. int8: a catalog
    whose second half repeats its first, so equal codes and scales give
    exactly tied dequantized scores (float(raw) · su) · si."""
    excluded = np.random.default_rng(41 + k).random((3, 700)) < 0.4
    excluded[2, 5:] = True                          # five eligible items
    if kind == "f32":
        u, it = _tied(40 + k, 3, 700, 8)
        scores = (u @ it.T).astype(np.float32)
        pv, pi = ttp.topk_fold_plain(
            torch.from_numpy(np.where(excluded, ttp.NEG_INF, scores)), k)
        return scores, excluded, pv.numpy(), pi.numpy()
    u, it = _gauss(40 + k, 3, 8), _gauss(43 + k, 700, 8)
    it[350:] = it[:350]
    q, s = ttp.row_quantize(torch.from_numpy(it))
    qu, su = ttp.row_quantize(torch.from_numpy(u))
    raw = qu.numpy().astype(np.int32) @ q.numpy().astype(np.int32).T
    scores = (raw.astype(np.float32) * su.numpy().reshape(-1, 1)) * s.numpy()
    pv, pi = ttp.streaming_mips_topk_int8_plain(
        torch.from_numpy(u), q, s, k, torch.from_numpy(excluded.astype(np.int8)))
    pv, pi = pv.numpy(), pi.numpy()
    if k > 1:
        assert (pv[:, 1:] == pv[:, :-1])[pv[:, 1:] > ttp.NEG_INF].any()   # exact ties
    return scores, excluded, pv, pi


def _fold_params():
    """(kind, k) cases; kernel B's keep their ids of one parameter."""
    return [pytest.param(kind, k, id=str(k) if kind == "f32" else f"int8-{k}")
            for kind in ("f32", "int8") for k in (1, 12, 33, 256)]


@pytest.mark.parametrize("kind,k", _fold_params())
def test_kernel_fold_matches_plain(kind, k):
    """The fold kernels B and C share, emulated in Python, gives the plain
    version's values and ids whatever order the candidates arrive in, on
    tied scores with exclusions and on rows with fewer than k eligible
    items."""
    scores, excluded, pv, pi = _fold_case(kind, k)
    rng = np.random.default_rng(42 + k)
    for r in range(3):
        order = rng.permutation(700) if r else np.arange(700)
        lst = _emulate_fold(scores[r], excluded[r], k, order)[:k]
        np.testing.assert_array_equal(np.array([v for v, _ in lst], np.float32), pv[r])
        np.testing.assert_array_equal(np.array([j for _, j in lst]), pi[r])


@pytest.mark.parametrize("kind,k", _fold_params())
def test_split_lists_merge_to_plain(kind, k):
    """The catalog cut into splits of whole 128-item tiles (the last one
    short), each folded in its own order, then the merge pass over the
    per-split lists: the plain version's values and ids."""
    scores, excluded, pv, pi = _fold_case(kind, k)
    rng = np.random.default_rng(44 + k)
    bounds = [0, 256, 512, 700]
    for r in range(3):
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            order = rng.permutation(hi - lo)
            parts.append(_emulate_fold(scores[r, lo:hi], excluded[r, lo:hi], k, order,
                                       ids=np.arange(lo, hi)))
        lst = _emulate_merge(parts, k)
        np.testing.assert_array_equal(np.array([v for v, _ in lst], np.float32), pv[r])
        np.testing.assert_array_equal(np.array([j for _, j in lst]), pi[r])


def _order_key(e):
    return (-e[0], e[1])


def _emulate_int8_split(scores, excluded, ids, k, rng):
    """Kernel C's candidate path (csrc/topk.cu) for one user over one split:
    runs of 128 items, item tx + 16·j of a run held by lane tx; the exact
    test against the k-th entry and the mask; for k ≤ 16 the run bound where
    a lane holds more than 2 candidates (or, at random, where the warp's
    other user asks for it); then ``offer_user``: every candidate offered in
    no fixed order, a full buffer merged at once, the threshold re-read after
    a merge and raised to the run bound."""
    lst, buf, thr = [(ttp.NEG_INF, 0)] * _list_len(k), [], (ttp.NEG_INF, 0)
    for r0 in range(0, len(scores), 128):
        lanes = [[p for p in range(r0 + tx, min(r0 + 128, len(scores)), 16)] for tx in range(16)]
        keep = [[(scores[p], int(ids[p])) for p in lane
                 if not excluded[p] and _better((scores[p], int(ids[p])), thr)] for lane in lanes]
        bound = None
        if k <= 16 and (any(len(c) > 2 for c in keep) or rng.random() < 0.3):
            bests = sorted((min(c, key=_order_key) if c else (ttp.NEG_INF, _PAD_ID)
                            for c in keep), key=_order_key)
            bound = bests[k - 1]
            keep = [[e for e in c if not _better(bound, e)] for c in keep]
        cands = [e for c in keep for e in c]
        rng.shuffle(cands)
        merged = False
        for cand in cands:
            if len(buf) == 64:
                lst, buf, merged = _merge_list(lst, buf), [], True
            buf.append(cand)
        if merged:
            thr = lst[k - 1]
        if bound is not None and _better(bound, thr):
            thr = bound
    if buf:
        lst = _merge_list(lst, buf)
    return lst


@pytest.mark.parametrize("k", [1, 5, 12, 16, 33])
def test_int8_candidate_path_matches_plain(k):
    """Kernel C's own candidate path around the shared fold, emulated in
    Python over four splits and the merge pass, on exactly tied int8 scores
    with exclusions: each split's k best, then the plain version's values
    and ids."""
    scores, excluded, pv, pi = _fold_case("int8", k)
    rng = np.random.default_rng(45 + k)
    bounds = [0, 128, 256, 512, 700]   # splits of one run, two runs, a short last run
    for r in range(3):
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = _emulate_int8_split(scores[r, lo:hi], excluded[r, lo:hi], np.arange(lo, hi), k, rng)
            sv, si = ttp.topk_fold_plain(torch.from_numpy(
                np.where(excluded[r:r + 1, lo:hi], ttp.NEG_INF, scores[r:r + 1, lo:hi])), k)
            split_ids = np.where(sv[0].numpy() > ttp.NEG_INF, si[0].numpy() + lo, 0)
            assert part[:k] == list(zip(sv[0].tolist(), split_ids.tolist()))   # each split's k best
            parts.append(part)
        lst = _emulate_merge(parts, k)
        np.testing.assert_array_equal(np.array([v for v, _ in lst], np.float32), pv[r])
        np.testing.assert_array_equal(np.array([j for _, j in lst]), pi[r])


def test_int8_wrapper_refuses_bad_k_and_other_devices():
    """Kernel C's wrapper refuses a k outside [1, MAX_K] and a device that is
    neither CPU nor CUDA."""
    u, q, s = torch.zeros((3, 20)), torch.zeros((40, 20), dtype=torch.int8), torch.ones((1, 40))
    for k in (0, ttp.MAX_K + 1):
        with pytest.raises(ValueError, match="k must be"):
            ttp.streaming_mips_topk_int8(u, q, s, k)
    with pytest.raises(ValueError, match="unsupported device"):
        ttp.streaming_mips_topk_int8(u.to("meta"), q.to("meta"), s.to("meta"), 5)


# ---- exclusions at fixed shapes ------------------------------------------------
# Each helper against the boolean-index version it replaced (kept below, as
# plain PyTorch), bit for bit, and against the JAX package where it has the
# helper; the caller's tensors are never written.

EX_B, EX_I = 5, 24


def _exclusion_case(case):
    """(exclude_items int32 [B, X], exclude_count int32 [B] or None, k)."""
    rng = np.random.default_rng(60)
    ex = np.full((EX_B, 6), -1, np.int32)
    cnt = np.zeros(EX_B, np.int32)
    for r in range(EX_B):
        c = int(rng.integers(1, 6))
        ex[r, :c], cnt[r] = rng.choice(EX_I, c, replace=False), c
    k = 4
    if case == "count_zero":
        cnt[[0, 3]] = 0                       # ids in the slots, none counted
    elif case == "full_rows":
        ex = rng.permuted(np.tile(np.arange(EX_I, dtype=np.int32), (EX_B, 1)), axis=1)[:, :6]
        cnt[:] = 6
    elif case == "pads_inside_count":
        ex[:, 1] = -1
        cnt[:] = np.maximum(cnt, 3)
    elif case == "past_catalog":
        ex[1, 0], ex[2, :2] = EX_I, [EX_I + 7, 1 << 20]
    elif case == "duplicates":
        ex[0, :4], cnt[0] = [3, 3, 9, 3], 4
        ex[4, :2], cnt[4] = [ex[4, 0], ex[4, 0]], max(cnt[4], 2)
    elif case == "over_excluded":
        k = 6
        ex = np.full((EX_B, EX_I - 2), -1, np.int32)
        ex[2] = np.arange(2, EX_I)            # 2 items left for k = 6
        cnt[2] = EX_I - 2
        ex[0, :3], cnt[0] = [5, 6, 7], 3
    elif case == "k_is_catalog":
        k = EX_I
    elif case == "no_count":
        cnt = None
    return ex, cnt, k


EXCLUSION_CASES = ["count_zero", "full_rows", "pads_inside_count", "past_catalog", "duplicates",
                   "over_excluded", "k_is_catalog", "no_count"]


def _valid_slots(ex, cnt, num_items):
    x = ex.shape[1]
    valid = (ex >= 0) & (ex < num_items)
    if cnt is not None:
        valid &= torch.arange(x)[None, :] < cnt[:, None]
    return valid, torch.arange(ex.shape[0])[:, None].expand(ex.shape[0], x)


def _boolean_index_exclusion(scores, ex, cnt, fill=ttopk.EXCLUDE_FILL):
    valid, rows = _valid_slots(ex, cnt, scores.shape[1])
    out = scores.clone()
    out[rows[valid], ex[valid].long()] = fill
    return out


def _boolean_index_mask(num_items, ex, cnt):
    valid, rows = _valid_slots(ex, cnt, num_items)
    mask = torch.zeros((ex.shape[0], num_items), dtype=torch.int8)
    mask[rows[valid], ex[valid].long()] = 1
    return mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", EXCLUSION_CASES)
def test_apply_exclusion_fixed_shape(case):
    ex, cnt, _ = _exclusion_case(case)
    scores = torch.from_numpy(_gauss(61, EX_B, EX_I))
    before = scores.clone()
    out = ttopk.apply_exclusion(scores, _t(ex), _t(cnt))
    assert torch.equal(scores, before)
    assert out.shape == scores.shape and out.is_contiguous()
    assert torch.equal(out, _boolean_index_exclusion(scores, _t(ex), _t(cnt)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jtopk.apply_exclusion(
        jnp.asarray(before.numpy()), ex, cnt)))


@pytest.mark.parametrize("case", EXCLUSION_CASES)
def test_masked_topk_fixed_shape(case):
    """``masked_topk`` on the caller's scores, and ``mips_topk`` (which
    fills its own product in place), against the boolean-index exclusion
    and one top-k: values and ids bit for bit, ties included."""
    ex, cnt, k = _exclusion_case(case)
    u, it = torch.from_numpy(_gauss(62, EX_B, 8)), torch.from_numpy(_gauss(63, EX_I, 8))
    scores = u @ it.T
    before = scores.clone()
    ref_v, ref_i = torch.topk(_boolean_index_exclusion(scores, _t(ex), _t(cnt)), k, dim=1)
    for v, i in (ttopk.masked_topk(scores, k, _t(ex), _t(cnt)),
                 ttopk.mips_topk(u, it, k, _t(ex), _t(cnt))):
        assert torch.equal(v, ref_v) and torch.equal(i, ref_i.to(torch.int32))
    assert torch.equal(scores, before)
    if case == "over_excluded":
        assert (ref_v[2, 2:] == ttopk.EXCLUDE_FILL).all()


@pytest.mark.parametrize("case", EXCLUSION_CASES)
def test_exclusion_mask_fixed_shape(case):
    ex, cnt, _ = _exclusion_case(case)
    ex_t, before = _t(ex), _t(ex).clone()
    mask = ttp.exclusion_mask(EX_I, ex_t, _t(cnt))
    assert torch.equal(ex_t, before)
    assert mask.dtype == torch.int8 and mask.shape == (EX_B, EX_I) and mask.is_contiguous()
    assert torch.equal(mask, _boolean_index_mask(EX_I, ex_t, _t(cnt)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jtp.exclusion_mask(EX_I, ex, cnt)))


@pytest.mark.parametrize("offset", [0, 7])
def test_exclusion_slots_over_a_stack_of_batches(offset):
    """Positions for a stack of batches at once are each batch's own, and
    stand in for items and counts in every helper that takes them."""
    ex = np.stack([_exclusion_case(c)[0] for c in ("count_zero", "past_catalog", "duplicates")])
    cnt = np.stack([_exclusion_case(c)[1] for c in ("count_zero", "past_catalog", "duplicates")])
    ex = ex + offset
    stack = ttopk.exclusion_slots(EX_I, _t(ex), _t(cnt), offset)
    assert stack.shape == ex.shape and stack.dtype == torch.int64
    for j in range(3):
        one = ttopk.exclusion_slots(EX_I, _t(ex[j]), _t(cnt[j]), offset)
        assert torch.equal(stack[j], one)
    if offset == 0:
        u, it = torch.from_numpy(_gauss(64, EX_B, 8)), torch.from_numpy(_gauss(65, EX_I, 8))
        for j in range(3):
            a = ttopk.mips_topk(u, it, 4, _t(ex[j]), _t(cnt[j]))
            b = ttopk.auto_mips_topk(u, it, 4, exclude_slots=stack[j])
            assert all(torch.equal(x, y) for x, y in zip(a, b))
            assert torch.equal(ttp.exclusion_mask(EX_I, exclude_slots=stack[j]),
                               ttp.exclusion_mask(EX_I, _t(ex[j]), _t(cnt[j])))
