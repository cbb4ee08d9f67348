"""The ordered segment sums of ``ops/sorted_sum`` and the sorted-sum kernel.

On the CPU: a plan with a ``valid`` mask against the padded plan over
``where``-zeroed values (bit for bit: the pads sit at the tail of row 0's
stable run and only add +0); the kernel's work list (``SumPlan.pieces``),
walked in the kernel's order, against the plain version; the fused edge sums
(``EdgeSums``) against the composition the SAGE model used before them, a
gather into [E, D] messages, ``where`` and ``SegmentSum`` (forward and
backward bit for bit, and ``gradcheck`` in f64); and the SAGE model's
encode, forward and gradients under ``add`` and ``mean`` against the same
model run through that composition.

On the card (``requires_cuda``; they skip here; run with
``python -m pytest --noconftest tests/test_torch_sorted_sum.py -m requires_cuda``):
the kernel against its plain version at the ranking cell's shapes, two
identical passes, the scalar route, the launch and tracer counts, and the
refusal of a table that is not f32. This file imports no JAX, so it runs on
the card machine.
"""
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu_torch.configs import Config
from laplace_gnn_recommendation_tpu_torch.data import link_pred_data as tlpd
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
from laplace_gnn_recommendation_tpu_torch.models import sage
from laplace_gnn_recommendation_tpu_torch.ops import sorted_sum as ss
from laplace_gnn_recommendation_tpu_torch.ops.sorted_sum import (
    PIECE_ROWS, EdgeSums, SegmentSum, SumPlan, gather_rows)
from laplace_gnn_recommendation_tpu_torch.utils.profiling import tracer


def _keys(rng, n, rows, n_valid, skew=0.0):
    """int64 [n] keys in [0, rows), popularity rank^-skew, the first
    ``n_valid`` valid and the rest pads keyed 0 (the sampler's layout), and
    the mask."""
    p = np.arange(1, rows + 1, dtype=np.float64) ** -skew
    key = rng.choice(rows, size=n, p=p / p.sum())
    key[n_valid:] = 0
    return torch.from_numpy(key), torch.arange(n) < n_valid


def _walk(plan, table, reads):
    """The kernel's arithmetic on the CPU, from its work list: each piece
    summed left to right from +0 in f32, into the row or its scratch slot,
    then each row of several pieces summed over its slots in order."""
    meta, row_end = (t.numpy() for t in plan.pieces())
    tab, rd = table.numpy(), reads.numpy()
    d = tab.shape[1]
    out = np.full((plan.sum_rows, d), np.nan, np.float32)
    part = np.full((meta.shape[0], d), np.nan, np.float32)
    for row, lo, hi, slot in meta:
        if row < 0:
            continue
        acc = np.zeros(d, np.float32)
        for k in range(lo, hi):
            acc = acc + tab[rd[k]]
        if slot < 0:
            out[row] = acc
        else:
            part[slot] = acc
    for r in range(plan.sum_rows):
        p0, p1 = (row_end[r - 1] if r else 0), row_end[r]
        if p1 - p0 > 1:
            acc = np.zeros(d, np.float32)
            for q in range(p0, p1):
                acc = acc + part[q]
            out[r] = acc
    out = torch.from_numpy(out)
    if plan.rows is None:
        return out
    return torch.zeros(plan.num_rows + 1, d).index_copy_(0, plan.rows, out)[: plan.num_rows]


# n, rows, valid entries, key skew
PLAN_CASES = {
    "pads_at_the_tail": (3000, 40, 1000, 0.0),
    "empty_rows": (400, 450, 300, 1.5),
    "one_row_of_5000": (5600, 1, 5000, 0.0),
    "distinct_rows": (300, 5000, 200, 0.0),
    "no_pads": (1000, 7, 1000, 0.8),
}


@pytest.mark.parametrize("d", [1, 12, 24, 128])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_valid_plan_equals_padded_plan(case, d):
    """A plan that leaves the pads out sums what the padded plan sums over
    ``where``-zeroed values, bit for bit, and the kernel's work list walked
    in its order gives the same bits as the plain version."""
    n, rows, n_valid, skew = PLAN_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + d)
    key, valid = _keys(rng, n, rows, n_valid, skew)
    v = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    plan = SumPlan(key, rows, valid)
    out = plan.sum(v)
    padded = SumPlan(key, rows).sum(torch.where(valid[:, None], v, 0.0))
    assert out.shape == (rows, d)
    assert torch.equal(out, padded)
    assert torch.equal(_walk(plan, v, plan.order), out)
    # every valid entry lies in exactly one piece; no pad does
    meta, row_end = plan.pieces()
    used = meta[meta[:, 0] >= 0]
    covered = torch.zeros(n, dtype=torch.long)
    for lo, hi in used[:, 1:3].tolist():
        covered[lo:hi] += 1
    assert torch.equal(covered, (torch.arange(n) < n_valid).long())
    assert int(row_end[-1]) == used.shape[0] <= meta.shape[0]
    assert int((used[:, 2] - used[:, 1]).max()) <= PIECE_ROWS


@pytest.mark.parametrize("case", ["long_runs", "distinct_rows", "all_pads_but_one"])
def test_plan_without_valid_is_unchanged(case):
    """Without ``valid`` the plain sums are the earlier plan's: every entry,
    pads included, in its stable run; here against ``index_add_`` in f64 and
    the work list's walk in f32."""
    n, rows = {"long_runs": (3000, 5), "distinct_rows": (100, 4000),
               "all_pads_but_one": (500, 30)}[case]
    rng = np.random.default_rng(n)
    key = torch.from_numpy(rng.integers(0, rows, n))
    if case == "all_pads_but_one":
        key[1:] = 0
    v = torch.from_numpy(rng.normal(size=(n, 6)))
    plan = SumPlan(key, rows)
    ref = torch.zeros(rows, 6, dtype=torch.float64).index_add_(0, key, v)
    np.testing.assert_allclose(plan.sum(v).numpy(), ref.numpy(), rtol=0, atol=1e-12)
    v32 = v.float()
    assert torch.equal(_walk(plan, v32, plan.order), plan.sum(v32))


def _parent_edge_sums(key_a, rows_a, key_b, rows_b, valid):
    """The composition the SAGE model summed its edges with before
    ``EdgeSums``: [E, D] gathered messages, pads zeroed by ``where``, one
    ``SegmentSum`` over the padded plan."""
    plan_a, plan_b = SumPlan(key_a, rows_a), SumPlan(key_b, rows_b)

    def through(x, key_in, plan_in, plan_out):
        msgs = torch.where(valid[:, None], gather_rows(x, key_in, plan_in), torch.zeros((),
                           dtype=x.dtype))
        return SegmentSum.apply(msgs, plan_out)

    class Parent:
        def to_a(self, x_b):
            return through(x_b, key_b, plan_b, plan_a)

        def to_b(self, x_a):
            return through(x_a, key_a, plan_a, plan_b)

    return Parent()


@pytest.mark.parametrize("d", [1, 12, 24, 128])
@pytest.mark.parametrize("skew", [0.0, 1.2])
def test_edge_sums_equal_the_composition(skew, d):
    """``EdgeSums.to_a`` / ``to_b`` and their gradients equal the gathered
    messages zeroed by ``where`` and summed by ``SegmentSum``, bit for bit;
    the forward also equals the work list's walk."""
    rng = np.random.default_rng(d + int(skew * 10))
    n, na, nb, n_valid = 4000, 70, 300, 1300
    key_a, valid = _keys(rng, n, na, n_valid)
    key_b, _ = _keys(rng, n, nb, n_valid, skew)
    xa = torch.from_numpy(rng.normal(size=(na, d)).astype(np.float32))
    xb = torch.from_numpy(rng.normal(size=(nb, d)).astype(np.float32))
    ga = torch.from_numpy(rng.normal(size=(na, d)).astype(np.float32))
    gb = torch.from_numpy(rng.normal(size=(nb, d)).astype(np.float32))
    fused = EdgeSums(key_a, na, key_b, nb, valid)
    parent = _parent_edge_sums(key_a, na, key_b, nb, valid)
    outs = []
    for sums in (fused, parent):
        a, b = xa.clone().requires_grad_(), xb.clone().requires_grad_()
        to_a, to_b = sums.to_a(b), sums.to_b(a)
        ((to_a * ga).sum() + (to_b * gb).sum()).backward()
        outs.append((to_a.detach(), to_b.detach(), a.grad, b.grad))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    assert torch.equal(_walk(fused.plan_a, xb, fused.reads_a), outs[0][0])
    assert torch.equal(_walk(fused.plan_b, xa, fused.reads_b), outs[0][1])


def test_edge_sums_gradcheck():
    """Both directions against finite differences in f64, with pads."""
    rng = np.random.default_rng(3)
    n, na, nb = 60, 5, 9
    key_a, valid = _keys(rng, n, na, 41)
    key_b, _ = _keys(rng, n, nb, 41, 1.0)
    sums = EdgeSums(key_a, na, key_b, nb, valid)
    xa = torch.from_numpy(rng.normal(size=(na, 3))).requires_grad_()
    xb = torch.from_numpy(rng.normal(size=(nb, 3))).requires_grad_()
    assert torch.autograd.gradcheck(sums.to_a, (xb,))
    assert torch.autograd.gradcheck(sums.to_b, (xa,))
    assert torch.autograd.gradgradcheck(sums.to_a, (xb,))


def _sage_case(agg):
    g = random_hetero_graph(seed=4, num_users=60, num_items=50, avg_degree=6)
    cfg = Config(batch_size=8, num_neighbors=16, n_hop_neighbors=2, hidden_layer_size=32,
                 encoder_layer_output_size=16, k=6, candidate_pool_size=10,
                 negative_edges_ratio=2.0, p_dropout_features=0.3, seed=5,
                 conv_agg_type=agg, dense_bytes_budget=0)
    data = tlpd.create_link_pred_data(g, cfg, device="cpu")
    batch = tlpd.create_samplers(cfg, data, randomization=False)[0].sample_batch(np.arange(8))
    assert not bool(batch.edge_mask.all()), "the batch should carry pad edges"
    params, bn = sage.init_sage_params(cfg, sage.get_feature_info(data.graph), device="cpu",
                                       generator=torch.Generator().manual_seed(1))
    return cfg, data, batch, params, bn


def _sage_run(cfg, data, batch, params, bn):
    for p in params.parameters():
        p.grad = None
    zu, zi, _ = sage.encode(params, bn, batch, data.user_features, data.item_features, cfg)
    logits, new_bn = sage.forward(params, bn, batch, data.user_features, data.item_features,
                                  cfg, train=True, generator=torch.Generator().manual_seed(2))
    sage.bce_loss(logits, batch).backward()
    grads = [p.grad.clone() for p in params.parameters()]
    stats = [new_bn[t][k] for t in sorted(new_bn) for k in sorted(new_bn[t])]
    return [zu.detach(), zi.detach(), logits.detach(), *stats, *grads]


@pytest.mark.parametrize("agg", ["add", "mean"])
def test_sage_unchanged_against_the_composition(agg, monkeypatch):
    """The SAGE model on the segment path (eval encode, train forward with
    dropout, every gradient) gives the same bits through ``EdgeSums`` as
    through the composition it replaced."""
    case = _sage_case(agg)
    fused = _sage_run(*case)
    monkeypatch.setattr(sage, "_EdgeSums", _parent_edge_sums)
    parent = _sage_run(*case)
    assert len(fused) == len(parent)
    for x, y in zip(fused, parent):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16, torch.float16])
def test_kernel_refuses_other_dtypes(dtype):
    """The kernel's wrapper takes f32 tables only; it refuses others before
    anything reaches a card."""
    plan = SumPlan(torch.tensor([0, 1, 1]), 2)
    with pytest.raises(ValueError, match="f32"):
        ss.sorted_sum_kernel(plan, torch.zeros(3, 4, dtype=dtype), plan.order32)


# ---- on the card -----------------------------------------------------------------

# the ranking cell's batch (gpu_bench/configs/sage-hm.json): edge slots, valid
# edges (the cell's mean), user and item slots
CELL_E, CELL_VALID, CELL_NU, CELL_NI = 2_113_536, 534_000, 33_024, 104_547


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def _cell_edges(dev, seed):
    """User and item slot keys at the cell's shapes: items by popularity
    rank^-0.8, users uniform, pads at the tail keyed 0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pop = torch.arange(1, CELL_NI + 1, device=dev, dtype=torch.float64) ** -0.8
    dst = torch.zeros(CELL_E, dtype=torch.int32, device=dev)
    src = torch.zeros(CELL_E, dtype=torch.int32, device=dev)
    dst[:CELL_VALID] = torch.multinomial(pop, CELL_VALID, replacement=True, generator=gen).int()
    src[:CELL_VALID] = torch.randint(0, CELL_NU, (CELL_VALID,), device=dev, generator=gen,
                                     dtype=torch.int32)
    return src, dst, torch.arange(CELL_E, device=dev) < CELL_VALID, gen


def _plain(fn):
    """``fn()`` with the plans' sums through the plain version on the card."""
    kernel = ss.sorted_sum_kernel
    ss.sorted_sum_kernel = ss.sorted_sum_plain
    try:
        return fn()
    finally:
        ss.sorted_sum_kernel = kernel


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [24, 128])
def test_kernel_against_plain_at_the_cell_shapes(d):
    """Both directions of the fused edge sums, and a plan's sum of [E, D]
    values, through the kernel and through the plain version: equal (bit
    for bit but for the sign of a zero), and the same bits on a second
    pass; one launch, and one ``sorted_sum.kernel_sums`` count, a sum."""
    from laplace_gnn_recommendation_tpu_torch import _build

    dev = _card()
    src, dst, valid, gen = _cell_edges(dev, d)
    sums = EdgeSums(src, CELL_NU, dst, CELL_NI, valid)
    xu = torch.randn(CELL_NU, d, device=dev, generator=gen)
    xi = torch.randn(CELL_NI, d, device=dev, generator=gen)
    values = torch.randn(CELL_E, d, device=dev, generator=gen)
    by_item = SumPlan(dst, CELL_NI)

    def run():
        return sums.to_a(xi), sums.to_b(xu), by_item.sum(values)

    _build.launches.clear()
    tracer.enable()
    try:
        got = run()
        _, counters = tracer.drain()
    finally:
        tracer.disable()
    assert _build.launches["sorted_sum"] == 3
    assert counters == {"sorted_sum.kernel_sums": 3}
    again = run()
    want = _plain(run)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [1, 5, 12, 64])
def test_kernel_scalar_and_vector_routes(d):
    """Widths that take single floats (D % 4 != 0, or a table not 16-byte
    aligned) and 16-byte vectors, on rows from empty to ~20,000 entries,
    against the plain version."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(d)
    n, rows = 200_000, 3_000
    pop = torch.arange(1, rows + 1, device=dev, dtype=torch.float64) ** -1.0
    key = torch.multinomial(pop, n, replacement=True, generator=gen)
    valid = torch.rand(n, device=dev, generator=gen) < 0.7
    plan = SumPlan(key, rows, valid)
    buf = torch.randn(n * d + 1, device=dev, generator=gen)
    for table in (buf[: n * d].view(n, d), buf[1:].view(n, d)):
        got = plan.sum(table)
        want = _plain(lambda: plan.sum(table))
        assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_kernel_refuses_other_dtypes_on_the_card(dtype):
    dev = _card()
    plan = SumPlan(torch.tensor([0, 1, 1], device=dev), 2)
    with pytest.raises(ValueError, match="f32"):
        plan.sum(torch.zeros(3, 4, dtype=dtype, device=dev))
