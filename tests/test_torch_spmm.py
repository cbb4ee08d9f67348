"""Propagation of the PyTorch port against the JAX package.

The port's ``pallas_segment_sum`` (its plain version on the CPU) is held
against the JAX Pallas ``pallas_segment_sum`` in interpret mode; the piece
plan the CUDA kernel walks is checked by emulating the kernel's schedule in
numpy; ``lightgcn_forward`` on both operand types is held against JAX's.

Tolerances: f32 sums taken in another order — rtol=1e-5, atol=1e-6 for one
segment sum, atol=1e-5 after K hops.
"""
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu.data.graph import BipartiteGraph as JGraph
from laplace_gnn_recommendation_tpu.models.lightgcn import LightGCNParams as JParams
from laplace_gnn_recommendation_tpu.models.lightgcn import lightgcn_forward as j_forward
from laplace_gnn_recommendation_tpu.ops import spmm_pallas as jsp
from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
from laplace_gnn_recommendation_tpu_torch.models.lightgcn import (
    lightgcn_forward,
    lightgcn_params_from_jax,
)
from laplace_gnn_recommendation_tpu_torch.ops import spmm_pallas as tsp
from laplace_gnn_recommendation_tpu_torch.ops.spmm import propagate_bipartite
from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import select_propagation

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


def _emulate_kernel(plan: tsp.PallasSegmentPlan, table: np.ndarray, groups: int) -> np.ndarray:
    """The schedule of csrc/segsum.cu in numpy. Each piece is summed in f32
    by ``groups`` lane groups — edge t of every 32-edge batch goes to group
    t % groups, with groups = 32 / L and L the power of two at or above
    D/4 (1 group for D above 64, 4 groups at D=32) —
    and the groups are combined by the kernel's xor butterfly;
    single-piece rows are written directly, heavy rows summed from their
    slots in piece order."""
    rp, src, w = plan.row_ptr.numpy(), plan.src.numpy(), plan.w.numpy()
    d = table.shape[1]
    out = np.full((plan.num_rows, d), np.nan, np.float32)
    partial = np.full((plan.num_slots, d), np.nan, np.float32)
    covered = np.zeros(len(src), np.int64)
    for p in range(plan.piece_row.shape[0]):
        row = int(plan.piece_row[p])
        lo = int(plan.piece_lo[p])
        hi = min(lo + plan.edges_per_piece, int(rp[row + 1]))
        acc = np.zeros((groups, d), np.float32)
        for e in range(lo, hi):
            g = ((e - lo) % 32) % groups
            acc[g] = (acc[g] + w[e] * table[src[e]]).astype(np.float32)
            covered[e] += 1
        off = 1
        while off < groups:   # butterfly: every group adds its xor partner
            acc = (acc + acc[np.arange(groups) ^ off]).astype(np.float32)
            off *= 2
        slot = int(plan.piece_slot[p])
        (out[row] if slot < 0 else partial[slot])[:] = acc[0]
    for h in range(plan.heavy_row.shape[0]):
        s0, s1 = int(plan.heavy_ptr[h]), int(plan.heavy_ptr[h + 1])
        acc = np.zeros(d, np.float32)
        for s in range(s0, s1):
            acc = (acc + partial[s]).astype(np.float32)
        out[int(plan.heavy_row[h])] = acc
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
    ("blocked", tsp.PallasGraph), ("auto", BipartiteGraph),
])
def test_select_propagation_modes(mode, kind):
    _, tg = _graph_pair(2, 10, 8, 30)
    assert isinstance(select_propagation(LightGCNConfig(propagation=mode), tg), kind)


@pytest.mark.parametrize("num_edges", [30, 0])
def test_select_propagation_auto_picks_kernel_on_card(monkeypatch, num_edges):
    """On a card graph ``auto`` always takes kernel A, an edgeless one too."""
    _, tg = _graph_pair(2, 10, 8, num_edges)
    monkeypatch.setattr(type(tg), "device", property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(tsp.PallasGraph, "from_graph", staticmethod(lambda g: "kernel A"))
    assert select_propagation(LightGCNConfig(propagation="auto"), tg) == "kernel A"


@pytest.mark.parametrize("mode", ["dense", "sharded"])
def test_select_propagation_unported_modes_raise(mode):
    _, tg = _graph_pair(2, 10, 8, 30)
    with pytest.raises(NotImplementedError, match="slice"):
        select_propagation(LightGCNConfig(propagation=mode), tg)
