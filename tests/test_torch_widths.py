"""Kernel widths the JAX package takes: any D.

Kernel A reads float4 rows with one lane each, so it takes widths that are
a multiple of 4 up to ``MAX_WIDTH`` (128); its wrapper runs every other
width in column blocks (``by_column_blocks``), each a fresh zero-padded
table. Kernel B's wrapper zero-pads rows to a multiple of 4
(``pad_columns``). On the CPU the wrappers run their plain versions, so
these tests drive the width logic with the plain version standing in for
the launch, under the kernel's own contract (width, contiguity,
alignment), and hold the result against the full-width plain version and
the JAX function.

Tolerances: a zero column adds nothing and columns never mix, so the
blocked segment sum equals the full-width one bit for bit; against the JAX
Pallas kernel (interpret mode) f32 sums in another order, rtol 1e-5, atol
1e-6. Scores with padded zero columns are the same dot products, summed
by BLAS in another blocking: atol 1e-6; against the JAX streaming kernel
(interpret mode) rtol and atol 1e-5 on scores of order √D.
"""
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu.ops import spmm_pallas as jsp
from laplace_gnn_recommendation_tpu.ops import topk_pallas as jtp
from laplace_gnn_recommendation_tpu_torch.ops import spmm_pallas as tsp
from laplace_gnn_recommendation_tpu_torch.ops import topk_pallas as ttp


def _edges(seed, rows, cols, n=900):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, rows, n))
    return dst, rng.integers(0, cols, n), rng.random(n).astype(np.float32)


def _kernel_launch(calls):
    """The plain version under the kernel's contract."""
    def launch(plan, table, gather_bf16):
        d = table.shape[1]
        assert d % 4 == 0 and 4 <= d <= tsp.MAX_WIDTH
        assert table.is_contiguous() and table.data_ptr() % 16 == 0
        calls.append(d)
        return tsp.pallas_segment_sum_plain(plan, table, gather_bf16)
    return launch


@pytest.mark.parametrize("gather_bf16", [False, True])
@pytest.mark.parametrize("d,blocks", [(30, [32]), (160, [128, 32]), (256, [128, 128]), (32, [32])])
def test_segment_sum_any_width(d, blocks, gather_bf16):
    rows, cols = 120, 70
    dst, src, w = _edges(d, rows, cols)
    plan = tsp.PallasSegmentPlan.from_edges(dst, src, w, rows, device="cpu")
    table = torch.from_numpy(np.random.default_rng(1).normal(size=(cols, d)).astype(np.float32))
    calls = []
    out = tsp.by_column_blocks(plan, table, gather_bf16, _kernel_launch(calls))
    assert calls == blocks
    full = tsp.pallas_segment_sum_plain(plan, table, gather_bf16)
    assert out.shape == (rows, d) and torch.equal(out, full)
    if not gather_bf16:
        jplan = jsp.PallasSegmentPlan.from_edges(dst, src, w, rows)
        ref = np.asarray(jsp.pallas_segment_sum(jplan, table.numpy(), interpret=True))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_strided_table_in_column_blocks():
    """A strided view (a slice of a wider table) is copied into blocks."""
    dst, src, w = _edges(3, 40, 30)
    plan = tsp.PallasSegmentPlan.from_edges(dst, src, w, 40, device="cpu")
    wide = torch.randn(30, 40, generator=torch.Generator().manual_seed(0))
    view = wide[:, 3:33]   # D=30, not contiguous
    calls = []
    out = tsp.by_column_blocks(plan, view, False, _kernel_launch(calls))
    assert calls == [32]
    assert torch.equal(out, tsp.pallas_segment_sum_plain(plan, view.contiguous()))


@pytest.mark.parametrize("d", [30, 160])
def test_kernel_b_padded_rows_keep_the_result(d):
    rng = np.random.default_rng(d)
    users = torch.from_numpy(rng.normal(size=(16, d)).astype(np.float32))
    items = torch.from_numpy(rng.normal(size=(300, d)).astype(np.float32))
    pu, pi = ttp.pad_columns(users), ttp.pad_columns(items)
    assert pu.shape[1] == -(-d // 4) * 4 and bool((pu[:, d:] == 0).all())
    assert torch.equal(pu[:, :d], users) and pu.is_contiguous()
    v, i = ttp.streaming_mips_topk_plain(pu, pi, 12)
    rv, ri = ttp.streaming_mips_topk_plain(users, items, 12)
    torch.testing.assert_close(v, rv, rtol=0, atol=1e-6)
    assert torch.equal(i, ri)
    # the JAX streaming kernel (interpret mode) computes the same at any width
    jv, ji = jtp.streaming_mips_topk(users.numpy(), items.numpy(), 12, tile=100, interpret=True)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
