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


@pytest.mark.parametrize("masked", [False, True])
def test_streaming_int8_bitwise_matches_jax_interpret(masked):
    b, i, d, k = 8, 1024, 32, 10
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
    """csrc/topk_f32.cu ``merge_list`` in Python: bitonic sort of the 64-entry
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


def _emulate_fold(scores, excluded, k, order):
    """Kernel B's fold for one user in Python: candidates offered in
    ``order``, a 64-entry buffer merged whenever it is full and at the end."""
    k_len = 32
    while k_len < k:
        k_len *= 2
    lst, buf = [(ttp.NEG_INF, 0)] * k_len, []
    for j in order:
        if excluded[j] or not _better((scores[j], j), lst[k - 1]):
            continue
        if len(buf) == 64:
            lst, buf = _merge_list(lst, buf), []
            if not _better((scores[j], j), lst[k - 1]):
                continue
        buf.append((scores[j], j))
    if buf:
        lst = _merge_list(lst, buf)
    return np.array([v for v, _ in lst[:k]], np.float32), np.array([j for _, j in lst[:k]])


@pytest.mark.parametrize("k", [1, 12, 33, 256])
def test_kernel_fold_matches_plain(k):
    """The fold csrc/topk_f32.cu runs, emulated in Python, gives the plain
    version's values and ids whatever order the candidates arrive in, on
    tied scores with exclusions and on rows with fewer than k eligible
    items."""
    u, it = _tied(40 + k, 3, 700, 8)
    scores = (u @ it.T).astype(np.float32)
    excluded = np.random.default_rng(41 + k).random(scores.shape) < 0.4
    excluded[2, 5:] = True                          # five eligible items
    pv, pi = ttp.topk_fold_plain(
        torch.from_numpy(np.where(excluded, ttp.NEG_INF, scores)), k)
    rng = np.random.default_rng(42 + k)
    for r in range(3):
        order = rng.permutation(700) if r else np.arange(700)
        v, ids = _emulate_fold(scores[r], excluded[r], k, order)
        np.testing.assert_array_equal(v, pv[r].numpy())
        np.testing.assert_array_equal(ids, pi[r].numpy())
