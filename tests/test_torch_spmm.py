"""Propagation of the PyTorch port against the JAX package.

The port's ``pallas_segment_sum`` (its plain version on the CPU) is held
against the JAX Pallas ``pallas_segment_sum`` in interpret mode, and its
bf16-gather mode against the JAX blocked tier's (``blocked_segment_sum``
with ``gather_bf16``); the window and piece plan the CUDA kernel walks is
checked by emulating the kernel's schedule in numpy; ``lightgcn_forward`` on
both operand types is held against JAX's, and ``select_propagation``'s bf16
rule against the JAX ``_maybe_bf16``.

Tolerances: f32 sums taken in another order — rtol=1e-5, atol=1e-6 for one
segment sum, atol=1e-5 after K hops. The bf16-gather mode forms the same
bf16 messages in both packages and sums them in f32 in another order, so
one segment sum gets the same tolerance.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu.data.graph import BipartiteGraph as JGraph
from laplace_gnn_recommendation_tpu.models.lightgcn import LightGCNParams as JParams
from laplace_gnn_recommendation_tpu.models.lightgcn import lightgcn_forward as j_forward
from laplace_gnn_recommendation_tpu.ops import spmm_blocked as jsb
from laplace_gnn_recommendation_tpu.ops import spmm_pallas as jsp
from laplace_gnn_recommendation_tpu.train import lightgcn_pipeline as jpipe
from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
from laplace_gnn_recommendation_tpu_torch.models.lightgcn import (
    lightgcn_forward,
    lightgcn_params_from_jax,
)
from laplace_gnn_recommendation_tpu_torch.ops import spmm_pallas as tsp
from laplace_gnn_recommendation_tpu_torch.ops.spmm import propagate_bipartite
from laplace_gnn_recommendation_tpu_torch.ops.spmm_dense import DenseAdjacency
from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import (
    BF16_GATHER_ROWS,
    select_propagation,
    uses_bf16_gather,
)

SEG_RTOL, SEG_ATOL = 1e-5, 1e-6
HOPS_ATOL = 1e-5


def _skewed_edges(seed, rows, cols):
    """Destination-sorted edges with an empty row (row 1), a row spanning
    more than one 512-edge tile (row 0: 1300 edges) and a ragged tail that
    leaves pad slots in the JAX tiles."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(1300, np.int64), rng.integers(2, rows, 700)])
    dst.sort()
    src = rng.integers(0, cols, dst.shape[0])
    w = rng.random(dst.shape[0]).astype(np.float32)
    return dst, src, w


def _lanes(d: int) -> int:
    """Lanes that read one table row in csrc/segsum.cu: the power of two at
    or above D/4."""
    lanes = 1
    while lanes < d // 4:
        lanes *= 2
    return lanes


def _piece_slots(d: int, piece_lanes: int) -> int:
    """Row slots a piece is summed in: the lanes it runs on (a warp, or
    max(lanes, 8)) over the lanes of one row."""
    lanes = _lanes(d)
    return (32 if piece_lanes == 32 else max(lanes, 8)) // lanes


def _butterfly(acc: np.ndarray) -> np.ndarray:
    """The kernel's xor butterfly over row slots, in f32: every slot adds
    its xor partner, offsets 1, 2, 4, ...; slot 0 holds the result."""
    off = 1
    while off < acc.shape[0]:
        acc = (acc + acc[np.arange(acc.shape[0]) ^ off]).astype(np.float32)
        off *= 2
    return acc[0]


def _emulate_kernel(plan: tsp.PallasSegmentPlan, table: np.ndarray, groups: int) -> np.ndarray:
    """The schedule of csrc/segsum.cu in numpy: pieces in launch order
    (window by window). Each piece is summed in f32 in ``groups`` row slots
    (edge t of the piece goes to slot t % groups; see ``_piece_slots``),
    combined by the kernel's xor butterfly; single-piece rows are written
    directly, and each heavy row sums its slots (in (window, piece) order)
    in 32/L row slots the same way, L the lanes of one row."""
    src, w = plan.src.numpy(), plan.w.numpy()
    d = table.shape[1]
    out = np.full((plan.num_rows, d), np.nan, np.float32)
    partial = np.full((plan.num_slots, d), np.nan, np.float32)
    covered = np.zeros(len(src), np.int64)
    for p in range(plan.piece_row.shape[0]):
        row = int(plan.piece_row[p])
        lo, hi = int(plan.piece_lo[p]), int(plan.piece_hi[p])
        assert 0 <= hi - lo <= plan.edges_per_piece
        acc = np.zeros((groups, d), np.float32)
        for e in range(lo, hi):
            g = (e - lo) % groups
            acc[g] = (acc[g] + w[e] * table[src[e]]).astype(np.float32)
            covered[e] += 1
        slot = int(plan.piece_slot[p])
        (out[row] if slot < 0 else partial[slot])[:] = _butterfly(acc)
    cgroups = 32 // _lanes(d)
    for h in range(plan.heavy_row.shape[0]):
        s0, s1 = int(plan.heavy_ptr[h]), int(plan.heavy_ptr[h + 1])
        acc = np.zeros((cgroups, d), np.float32)
        for s in range(s0, s1):
            g = (s - s0) % cgroups
            acc[g] = (acc[g] + partial[s]).astype(np.float32)
        out[int(plan.heavy_row[h])] = _butterfly(acc)
    assert (covered == 1).all(), "every edge belongs to exactly one piece"
    assert not np.isnan(out).any(), "every row is written"
    return out


@pytest.mark.parametrize("d", [8, 32, 100])
def test_segment_sum_matches_jax_pallas(d):
    rows, cols = 300, 90
    dst, src, w = _skewed_edges(d, rows, cols)
    table = np.random.default_rng(1).normal(size=(cols, d)).astype(np.float32)
    jplan = jsp.PallasSegmentPlan.from_edges(dst, src, w, rows)
    ref = np.asarray(jsp.pallas_segment_sum(jplan, table, interpret=True))
    plan = tsp.PallasSegmentPlan.from_edges(dst, src, w, rows, device="cpu")
    out = tsp.pallas_segment_sum(plan, torch.from_numpy(table)).numpy()
    np.testing.assert_allclose(out, ref, rtol=SEG_RTOL, atol=SEG_ATOL)
    assert (out[1] == 0).all()


@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("chunk", [1, 7, 512])
def test_kernel_schedule_matches_reference(chunk, groups):
    rows, cols, d = 40, 25, 4
    dst, src, w = _skewed_edges(chunk, rows, cols)
    dst, src, w = dst[::9], src[::9], w[::9]   # keep the python emulation short
    table = np.random.default_rng(2).normal(size=(cols, d)).astype(np.float32)
    plan = tsp.PallasSegmentPlan.from_edges(dst, src, w, rows, edges_per_piece=chunk, device="cpu")
    heavy_expected = np.flatnonzero(np.bincount(dst, minlength=rows) > chunk)
    np.testing.assert_array_equal(plan.heavy_row.numpy(), heavy_expected)
    ref = tsp.pallas_segment_sum_plain(plan, torch.from_numpy(table)).numpy()
    np.testing.assert_allclose(_emulate_kernel(plan, table, groups), ref, rtol=SEG_RTOL, atol=SEG_ATOL)


def test_plan_rejects_unsorted_edges():
    with pytest.raises(ValueError):
        tsp.PallasSegmentPlan.from_edges(np.array([1, 0]), np.array([0, 0]),
                                         np.ones(2, np.float32), 2)


def _graph_pair(seed, U, I, E):
    rng = np.random.default_rng(seed)
    eu, ei = rng.integers(0, U, E), rng.integers(0, I, E)
    return JGraph.from_edges(eu, ei, U, I), BipartiteGraph.from_edges(eu, ei, U, I, device="cpu")


def test_propagate_pallas_matches_jax():
    U, I, D = 70, 40, 16
    jg, tg = _graph_pair(0, U, I, 900)
    rng = np.random.default_rng(3)
    xu = rng.normal(size=(U, D)).astype(np.float32)
    xi = rng.normal(size=(I, D)).astype(np.float32)
    jpg = jsp.PallasGraph.from_graph(jg)
    ju, ji = jsp.propagate_pallas(jpg, xu, xi)
    tpg = tsp.PallasGraph.from_graph(tg)
    tu, ti = tsp.propagate_pallas(tpg, torch.from_numpy(xu), torch.from_numpy(xi))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=SEG_RTOL, atol=SEG_ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=SEG_RTOL, atol=SEG_ATOL)
    pu, pi = propagate_bipartite(tg, torch.from_numpy(xu), torch.from_numpy(xi))
    np.testing.assert_allclose(pu.numpy(), tu.numpy(), rtol=SEG_RTOL, atol=SEG_ATOL)
    np.testing.assert_allclose(pi.numpy(), ti.numpy(), rtol=SEG_RTOL, atol=SEG_ATOL)


@pytest.mark.parametrize("operand", ["pallas", "plain"])
def test_lightgcn_forward_matches_jax(operand):
    U, I, D, K = 60, 45, 16, 3
    jg, tg = _graph_pair(1, U, I, 700)
    rng = np.random.default_rng(4)
    ue = (rng.normal(size=(U, D)) * 0.1).astype(np.float32)
    ie = (rng.normal(size=(I, D)) * 0.1).astype(np.float32)
    ref = j_forward(JParams(ue, ie), jsp.PallasGraph.from_graph(jg), K)
    params = lightgcn_params_from_jax(ue, ie, device="cpu")
    op = tsp.PallasGraph.from_graph(tg) if operand == "pallas" else tg
    out = lightgcn_forward(params, op, K)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=HOPS_ATOL)
    np.testing.assert_array_equal(out[1].numpy(), ue)


@pytest.mark.parametrize("mode,kind", [
    ("plain", BipartiteGraph), ("pallas", tsp.PallasGraph),
    ("blocked", tsp.PallasGraph), ("auto", DenseAdjacency), ("dense", DenseAdjacency),
])
def test_select_propagation_modes(mode, kind):
    _, tg = _graph_pair(2, 10, 8, 30)
    assert isinstance(select_propagation(LightGCNConfig(propagation=mode), tg), kind)


@pytest.mark.parametrize("num_edges", [30, 0])
def test_select_propagation_auto_picks_kernel_on_card(monkeypatch, num_edges):
    """On a card graph too large for the dense budget ``auto`` takes kernel
    A; an edgeless one stays the graph itself, as in the JAX ``maybe_dense``."""
    _, tg = _graph_pair(2, 10, 8, num_edges)
    monkeypatch.setattr(type(tg), "device", property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(tsp.PallasGraph, "from_graph", staticmethod(lambda g, **kw: "kernel A"))
    op = select_propagation(LightGCNConfig(propagation="auto", dense_bytes_budget=0), tg)
    assert op == ("kernel A" if num_edges else tg)


@pytest.mark.parametrize("mode", ["sharded"])
def test_select_propagation_unported_modes_raise(mode):
    _, tg = _graph_pair(2, 10, 8, 30)
    with pytest.raises(NotImplementedError, match="slice"):
        select_propagation(LightGCNConfig(propagation=mode), tg)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [8, 32, 100])
def test_bf16_gather_matches_jax_blocked(d, seed):
    """The plain bf16-gather mode against the JAX blocked tier's: the same
    bf16 messages, summed in f32 in another order."""
    rows, cols = 300, 90
    dst, src, w = _skewed_edges(10 * seed + d, rows, cols)
    table = np.random.default_rng(seed).normal(size=(cols, d)).astype(np.float32)
    jplan = jsb.BlockedSegmentPlan.from_edges(dst, src, w, rows)
    ref = np.asarray(jsb.blocked_segment_sum(jplan, table, gather_bf16=True))
    plan = tsp.PallasSegmentPlan.from_edges(dst, src, w, rows, device="cpu")
    out = tsp.pallas_segment_sum(plan, torch.from_numpy(table), gather_bf16=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=SEG_RTOL, atol=SEG_ATOL)
    f32 = tsp.pallas_segment_sum(plan, torch.from_numpy(table)).numpy()
    assert np.abs(out - f32).max() > 1e-4   # the mode computes another function


@pytest.mark.parametrize("seed", [1, 5])
def test_bf16_forward_matches_jax_blocked(seed):
    U, I, D, K = 60, 45, 16, 3
    jg, tg = _graph_pair(seed, U, I, 700)
    rng = np.random.default_rng(seed + 10)
    ue = (rng.normal(size=(U, D)) * 0.1).astype(np.float32)
    ie = (rng.normal(size=(I, D)) * 0.1).astype(np.float32)
    jbg = dataclasses.replace(jsb.BlockedGraph.from_graph(jg), gather_bf16=True)
    ref = j_forward(JParams(ue, ie), jbg, K)
    params = lightgcn_params_from_jax(ue, ie, device="cpu")
    out = lightgcn_forward(params, tsp.PallasGraph.from_graph(tg, gather_bf16=True), K)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=HOPS_ATOL)


@pytest.mark.parametrize("users,items", [
    (BF16_GATHER_ROWS - 1, 7), (BF16_GATHER_ROWS, 7),
    (7, BF16_GATHER_ROWS - 1), (7, BF16_GATHER_ROWS),
])
def test_bf16_rule_matches_jax(users, items):
    """The port's rule against the JAX ``_maybe_bf16`` on stub graphs."""
    @dataclasses.dataclass
    class StubOperand:
        gather_bf16: bool = False

    stub = SimpleNamespace(num_users=users, num_items=items, device=torch.device("cpu"))
    jax_op = jpipe._maybe_bf16(StubOperand(), stub)
    assert BF16_GATHER_ROWS == jpipe.BF16_GATHER_ROWS
    assert uses_bf16_gather(stub) == jax_op.gather_bf16
    assert uses_bf16_gather(stub) == (max(users, items) >= 1 << 19)


@pytest.mark.parametrize("rows", [BF16_GATHER_ROWS - 1, BF16_GATHER_ROWS])
@pytest.mark.parametrize("mode", ["pallas", "blocked", "auto", "plain"])
def test_select_propagation_bf16_flag(monkeypatch, mode, rows):
    """``blocked`` and ``auto`` (past the dense budget) take the bf16-gather
    mode exactly where the rule holds, ``pallas`` never; ``plain`` stays the
    f32 reference. No plan is built at that size."""
    stub = SimpleNamespace(num_users=rows, num_items=7, num_edges=1,
                           device=torch.device("cpu"))
    seen = {}

    def fake_from_graph(g, **kw):
        seen.update(kw)
        return "kernel A"

    monkeypatch.setattr(tsp.PallasGraph, "from_graph", staticmethod(fake_from_graph))
    op = select_propagation(LightGCNConfig(propagation=mode, dense_bytes_budget=0), stub)
    bf16 = rows >= BF16_GATHER_ROWS
    if mode == "plain":
        assert op is stub
    else:
        assert op == "kernel A" and seen["width"] == LightGCNConfig().hidden_layer_size
        assert seen.get("gather_bf16", False) == (bf16 and mode != "pallas")


def _window_edges():
    """Destination-sorted edges over 50 source rows: row 0 is heavy (300
    edges), rows 1 and 4 are empty, the rest light; sources in no order
    within a row."""
    rng = np.random.default_rng(7)
    dst = np.concatenate([np.zeros(300, np.int64), rng.integers(2, 12, 90)])
    dst = dst[(dst != 4)]
    dst.sort()
    return dst, rng.integers(0, 50, dst.shape[0]), rng.random(dst.shape[0]).astype(np.float32)


@pytest.mark.parametrize("window_rows,chunk", [
    (0, 512),    # one window
    (7, 512),    # many windows
    (3, 16),     # windows smaller than the heavy row, which spans several pieces in each
    (50, 16),    # one window holding the whole source range
])
def test_windowed_plan_properties(window_rows, chunk):
    dst, src, w = _window_edges()
    rows, cols = 12, 50
    plan = tsp.PallasSegmentPlan.from_edges(dst, src, w, rows, edges_per_piece=chunk,
                                            device="cpu", num_src_rows=cols,
                                            window_rows=window_rows)
    wr = window_rows if 0 < window_rows < cols else cols
    # windows partition the source range
    assert plan.num_windows == -(-cols // wr)
    spans = [np.arange(k * wr, min((k + 1) * wr, cols)) for k in range(plan.num_windows)]
    np.testing.assert_array_equal(np.concatenate(spans), np.arange(cols))
    # every edge lies in exactly one (window, piece), and its source in that window
    psrc = plan.src.numpy()
    covered = np.zeros(len(psrc), np.int64)
    wp = plan.window_pieces
    assert wp[0] == 0 and wp[-1] == plan.piece_row.shape[0] and list(wp) == sorted(wp)
    for k in range(plan.num_windows):
        for p in range(wp[k], wp[k + 1]):
            lo, hi = int(plan.piece_lo[p]), int(plan.piece_hi[p])
            covered[lo:hi] += 1
            assert (psrc[lo:hi] // wr == k).all()
    assert (covered == 1).all()
    # the plan holds the same edges (re-ordered within rows only)
    rp = plan.row_ptr.numpy()
    for r in range(rows):
        a = sorted(zip(src[dst == r].tolist(), w[dst == r].tolist()))
        b = sorted(zip(psrc[rp[r]:rp[r + 1]].tolist(), plan.w.numpy()[rp[r]:rp[r + 1]].tolist()))
        assert a == b
    # every row is written once: by its one piece, or by the combine pass
    pieces_per_row = np.bincount(plan.piece_row.numpy(), minlength=rows)
    assert (pieces_per_row >= 1).all()
    np.testing.assert_array_equal(plan.heavy_row.numpy(), np.flatnonzero(pieces_per_row > 1))
    if window_rows == 3:
        assert pieces_per_row[0] > plan.num_windows   # the heavy row: several pieces a window
    # the numpy walk in the kernel's summation order matches index_add_
    table = np.random.default_rng(8).normal(size=(cols, 8)).astype(np.float32)
    ref = torch.zeros((rows, 8)).index_add_(
        0, torch.from_numpy(dst), torch.from_numpy(w)[:, None] * torch.from_numpy(table)[src]
    ).numpy()
    walked = _emulate_kernel(plan, table, _piece_slots(8, plan.piece_lanes))
    np.testing.assert_allclose(walked, ref, rtol=SEG_RTOL, atol=SEG_ATOL)
    assert (walked[[1, 4]] == 0).all()
    np.testing.assert_allclose(
        tsp.pallas_segment_sum(plan, torch.from_numpy(table)).numpy(), ref,
        rtol=SEG_RTOL, atol=SEG_ATOL)


@pytest.mark.parametrize("degrees,lanes", [
    ([tsp.SHORT_PIECE_EDGES] * 20, 8),
    ([tsp.SHORT_PIECE_EDGES + 1] * 20, 32),
    ([4] * 200 + [512], 32),   # short on average, but most edges lie in one long piece
])
def test_piece_lanes_follow_edge_weighted_piece_length(degrees, lanes):
    """Pieces run on 8 lanes when the piece an edge lies in holds
    ``SHORT_PIECE_EDGES`` edges or fewer on average, else on a warp."""
    dst = np.repeat(np.arange(len(degrees)), degrees)
    plan = tsp.PallasSegmentPlan.from_edges(dst, np.random.default_rng(9).integers(0, 9, dst.size),
                                            np.ones(dst.size, np.float32), len(degrees))
    assert plan.piece_lanes == lanes


@pytest.mark.parametrize("gather_bf16,l2_bytes,windows", [
    (False, 0, 1), (False, 640, 7), (True, 640, 4), (True, 10 ** 6, 1),
])
def test_window_size_follows_l2_and_mode(gather_bf16, l2_bytes, windows):
    """Windows hold ``L2_WINDOW_SHARE`` of the L2 in rows of the gathered
    width: bf16 rows are half as wide, so a window holds twice as many."""
    _, tg = _graph_pair(3, 70, 40, 500)
    pg = tsp.PallasGraph.from_graph(tg, width=8, gather_bf16=gather_bf16, l2_bytes=l2_bytes)
    row_bytes = 8 * (2 if gather_bf16 else 4)
    rows = int(tsp.L2_WINDOW_SHARE * l2_bytes) // row_bytes
    assert pg.to_item.window_rows == (rows if 0 < rows < 70 else 0)
    assert pg.to_item.num_windows == windows and pg.gather_bf16 == gather_bf16
