#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``laplace_gnn_recommendation_tpu_torch``)
on one NVIDIA H100: ``python3 chip_smoke.py`` from the repository root.

1. Card: prints ``nvidia-smi``'s name and power limit and builds the CUDA
   kernels from ``laplace_gnn_recommendation_tpu_torch/csrc`` (timed).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes: the segment-sum kernel (A) on both directions of the
   H&M-shaped train graph, in the bf16-gather mode ``auto`` takes there and
   in the f32 mode, at D=32 and at D=100, timed per direction and per
   propagation step, with its layout options swept (source windows for the
   direction whose source table exceeds L2, the lanes a piece runs on);
   the f32 streaming top-k (B)
   with and without a mask at B=256, I=104,547 (k=12 and k=256), on tied
   scores (ids equal to the plain version's) and at the B=512, I=270,336
   shape ``auto_mips_topk`` streams; the int8 streaming top-k (C) with and
   without a mask, at k=1, 33 and 256, at the padded shape the server
   streams, and bitwise against its plain version on exact ties, a user
   with 3 eligible items, k=1 and 33, D=20 and D=7 (unaligned rows and
   mask) and a catalog that is not 16-byte aligned. Each kernel's time, its
   plain version's time and one PyTorch library call's time (measured here
   only) are taken two ways: device time with the host's enqueue hidden
   (``device_ms``: CUDA events over as many calls as keep the launch queue
   from filling, beside the profiled kernel sum of the same calls, which
   stands in their place where the two differ by more than 20%; ``ms`` and
   ``library_ms`` in the ``kernels`` line) and the
   calls issued back to back, host work included (``time_ms``: ``call_ms``
   and ``library_call_ms``); ``host_ms`` is the host's time to issue one
   wrapper call.
3. Main path at full width: LightGCN defaults (D=32, K=4) over H&M
   cardinalities (1,371,980 users × 104,547 items, ~25M train edges) —
   ``select_propagation`` → ``lightgcn_forward`` through kernel A, a quantized
   and an f32 ``RetrievalServer`` answering 1,000 users with train-item
   exclusions (kernel C), and one ``auto_mips_topk`` call that streams
   through kernel B. Launch counters are zeroed before and read after. The
   forward is held against the plain forward in the same mode.
4. The main path once more under ``torch.profiler``: kernel time by name
   and the card's idle share of the host wall time.
5. Training at the same full width, on ``create_lightgcn_data``'s 80/10/10
   split, at ``bench_hm.make_cfg``'s settings (D=32, K=4, batch 32,768, lr
   1e-2, λ 1e-6, ``lr_decay_every`` 14, ``eval_user_cap`` 20,000,
   ``select_best_val``, ``propagation="auto"``: kernel A's bf16-gather
   mode): one batch's gradients of ``bpr_loss`` w.r.t. both E⁰ tables
   through the self-adjoint loop over kernel A, held against the same loop
   over kernel A's plain version in both modes and, in the f32 mode,
   against plain autograd through ``ops/spmm.py``; a timed
   ``make_train_step`` step (kernel A's launches a step from the counters,
   its phases, a ``torch.profiler`` split by kernel name, the card's idle
   share, peak memory); then ``train()`` end to end for a few tens of steps
   with evals, checkpoints and best-val selection, run twice with one seed,
   and resumed from its newest checkpoint. Kernel A is also held against
   its plain version at D=30 and D=160 (padded columns, column blocks), and
   kernel B at D=30 (padded rows) and D=160 (column-chunked tiles).
6. The dense tier at MovieLens-1M shape (``movielens_like_edges(seed=0)``:
   6,040 × 3,706, ~1M interactions; D=32, K=4, ``LightGCNConfig``
   defaults): ``auto`` must pick ``DenseAdjacency`` as the JAX rule does; its
   forward is held against the same tier on the CPU and against the plain
   f32 forward; the forward is timed beside kernel A's on the same graph, and
   one ``make_train_step`` step on it.
7. The ranking stack at ``Config``'s widths (hidden 128, output 64, 2 GNN
   and 2 linear layers, ``add`` / ``sum``) on ``bench_encdec_scale.py``'s
   graph (200,000 users × 50,000 items, average degree 16, 2 + 2 features of
   cardinality 64; batch 256, 24 neighbours, 2 hops, k 12, pool 20, probed
   budgets): the native sampler must build; sampler batches/s with 1 and 2
   workers; one train step (device and call ms, idle share, peak memory,
   dense or segment path); the step's kernel time with its row gathers'
   sorted segment sums against ``F.embedding`` and ``table[idx]`` as the
   gather, and whether one batch's gradients repeat bit for bit (they must
   with the port's own); train users/s through sampler + prefetch + step;
   eval users/s; ``RankingServer.recommend`` for 1,000 users; one
   ``conv_agg_type="max"`` step (the segment path) held against the same
   step in f64 on the CPU. Then ``run_pipeline`` at the same widths on a
   20,000 × 5,000 graph for 3 epochs, twice with one seed on the dense
   subgraph path and twice on the segment path, and a resume leg.
   These paths launch none of the three kernels: their counters are zeroed
   before each and read after.
8. PinSAGE at ``bench_pinsage.py:28-30``'s width on phase 3's H&M edges
   (1,371,980 × 104,547; walk length 2, 10 walks, 3 neighbours, 2 layers,
   hidden 64, batch 512; one constant item feature, as the bench has): the
   native library must build; walks/s through the native and the Python
   frontier; ``sample_train_batch`` batches/s; one dense-Adam and one
   ``sparse_embedding`` step (device and call ms, idle share, peak memory);
   one batch's gradients bit for bit over two passes, and the margin loss
   and its gradients against f64 on the CPU; ``embed_all_items`` over the
   catalog and ``hits_at_k`` on 20,000 users. Then the artifacts path:
   ml-1m-format files at MovieLens-1M's size → ``preprocess`` →
   ``run_pinsage_cli`` and a ``train()`` resumed from its checkpoint
   (files in ``_chip/smoke_movielens/``, removed), and
   ``create_link_pred_data_from_artifacts`` → ``run_pipeline`` (2 epochs)
   → ``submission_pipeline`` from its checkpoint, a MAP@12 CSV. Kernels A,
   B and C launch 0 times on this path (counters zeroed before, read
   after).
9. Prints a ``{"kernels": [...]}`` JSON line, the card's line, and as the
   last line ``{"ok": true, "device": {...}}``.

Any failure exits nonzero; the script needs a CUDA card and the checkout.
"""
import dataclasses
import json
import os
import shutil
import warnings
import subprocess
import sys
import time

import numpy as np

NUM_USERS = 1_371_980   # H&M customers (bench_hm.py)
NUM_ITEMS = 104_547     # H&M articles
AVG_DEGREE = 23.0
POPULARITY_ALPHA = 0.8
SERVE_USERS = 1_000
BIG_B, BIG_I = 512, 270_336   # B·I·4 > 512 MiB and I % 512 == 0: streams
WIDE_D = 100   # kernel A's check at a width that leaves lanes idle
ODD_WIDTHS = (30, 160)   # widths the wrappers pad (30) or cut into column blocks (160)
# training: bench_hm.make_cfg's settings; a few tens of steps
TRAIN_CFG = dict(hidden_layer_size=32, num_iterations=4, batch_size=32_768, learning_rate=1e-2,
                 Lambda=1e-6, lr_decay_every=14, eval_user_cap=20_000, select_best_val=True,
                 propagation="auto")
TRAIN_STEPS, TRAIN_EVAL_EVERY, TRAIN_CKPT_EVERY, RESUME_STEPS = 30, 10, 10, 10
TRAIN_DIR = os.path.join("_chip", "smoke_train")   # checkpoints, removed at the end
# the ranking stack: bench_encdec_scale.py's graph and sampler settings
RANK_USERS, RANK_ITEMS, RANK_DEGREE, RANK_FEATURE_CARD = 200_000, 50_000, 16, 64
RANK_CFG = dict(batch_size=256, num_neighbors=24, n_hop_neighbors=2, k=12,
                candidate_pool_size=20, budget_probe=8)
RANK_TIMED_BATCHES, RANK_SERVE_USERS = 30, 1_000
# run_pipeline's training outcome, on a graph cut so three epochs fit
PIPE_USERS, PIPE_ITEMS, PIPE_EPOCHS = 20_000, 5_000, 3
PIPE_DIR = os.path.join("_chip", "smoke_encdec")   # checkpoints, removed at the end
# the max-aggregation step against f64 on the CPU: logits to this share of
# (1 + their largest); all gradients, as one vector, to this share of the
# reference's L2 norm (a segment maximum whose runner-up lies within f32
# rounding may route one entry's gradient to another message, so no
# per-entry bound is set on the gradients)
TOL_RANK_LOGITS, TOL_RANK_GRAD = 1e-4, 1e-3
# the dense tier against the plain f32 forward (bf16 Ã and operands, the JAX
# test's bound) and against itself on the CPU (f32 sums in another order)
TOL_DENSE_VS_PLAIN = (2e-3, 2e-2)   # (atol, rtol)
TOL_DENSE_CPU = 1e-5
# PinSAGE at bench_pinsage.py:28-30's width; walks/s over 40 native batches
# and 2 Python ones, sample_train_batch over 20; HITS on 20,000 users
PIN_CFG = dict(random_walk_length=2, num_random_walks=10, num_neighbors=3, num_layers=2,
               hidden_dims=64, batch_size=512, lr=3e-4, k=10)
PIN_NATIVE_BATCHES, PIN_PYTHON_BATCHES, PIN_ASM_BATCHES, PIN_HITS_USERS = 40, 2, 20, 20_000
# its margin loss on the card against f64 on the CPU: the loss to this share
# of (1 + |loss|), all gradients as one vector to this share of the
# reference's L2 norm (a ReLU input or a hinge within f32 rounding of its
# kink may switch; fresh weights keep that rare)
TOL_PIN_LOSS, TOL_PIN_GRAD = 1e-5, 1e-4
# the artifacts path: MovieLens-1M's published size, ranking stack 2 epochs
ML_USERS, ML_MOVIES, ML_RATINGS, ML_EPOCHS = 6_040, 3_883, 1_000_209, 2
ML_DIR = os.path.join("_chip", "smoke_movielens")   # files, checkpoints; removed at the end
WINDOW_SHARES = (0, 0.25, 0.5, 0.75)   # kernel A's window sizes tried, as shares of L2
# device_ms: launches the timed calls may queue behind the device-side sleep
# (the card's launch queue takes ~1,000); the event time stands where it is
# within this share of the profiled kernel sum of the same calls
LAUNCH_QUEUE = 512
DEVICE_MS_AGREE = 0.2

# H100 SXM published peaks (NVIDIA data sheet; dense, at a 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_INT8_S = 1979e12

TOL_SEGSUM = (1e-5, 1e-5)   # (atol, rtol): f32 sums in another order
TOL_TOPK_F32 = 1e-6         # abs, on scores ~1e-2: f32 dot in another order
# gradients of one batch, abs, as a share of the reference's largest entry:
# f32 sums in another order through 2·K hops; in the bf16-gather mode a
# bf16 rounding of a value whose f32 bits differ may flip (2^-8 of a message)
TOL_GRAD_F32 = 1e-5
TOL_GRAD_BF16 = 2.0 ** -7
# int8 (kernel C) must be bitwise equal: integer dots, the same two f32 roundings


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, reps):
    """Mean device ms of ``fn`` over ``reps`` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(torch, fn, reps):
    """(ms, launches) a call of ``fn`` under torch.profiler, means over
    ``reps`` calls: the sum of its kernels', copies' and sets' own device
    times, and how many of them it issues."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.self_device_time_total > 0]
    return (sum(ev.self_device_time_total for ev in evs) / 1e3 / reps,
            sum(ev.count for ev in evs) / reps)


def device_ms(torch, fn, reps, name="call"):
    """(device ms, host ms) of ``fn``: device time with the host's own time
    kept out, and the host's time to issue one call. (``time_ms`` times
    calls as a caller issues them, host work between launches included.)

    A device-side sleep holds the stream while the host enqueues the calls,
    so their kernels then run back to back between two events. If the calls
    issued more launches than the launch queue holds, the host would block
    before the sleep ends and the events would time the host's pace. So the
    calls are first profiled (:func:`kernel_ms`: kernel sum and launches a
    call), and the events time as many of the ``reps`` calls as keep at most
    ``LAUNCH_QUEUE`` launches queued (at least one). Where the events differ
    from the kernel sum by more than ``DEVICE_MS_AGREE`` of it (one call
    that alone overfills the queue, or the gaps between hundreds of small
    kernels, which the kernel sum leaves out), the kernel sum is the device
    time. Both are printed."""
    kernels, launches = kernel_ms(torch, fn, reps)
    n = max(1, min(reps, int(LAUNCH_QUEUE // max(launches, 1))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)   # cycles: twice the host time at 2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    events = start.elapsed_time(end) / n
    agree = abs(events - kernels) <= DEVICE_MS_AGREE * kernels
    log("device_ms:", json.dumps(dict(
        name=name, events_ms=events, kernels_ms=kernels, launches_per_call=launches,
        timed_calls=n, reported="events" if agree else "kernels", host_ms=host_s * 1e3 / n)))
    return (events if agree else kernels), host_s * 1e3 / n


def bound(bytes_moved, ops, peak_ops):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pick_int_mm(torch, b, q_items):
    """A ``torch._int_mm`` orientation cuBLASLt accepts for [B, D]·[I, D]ᵀ
    int8 scores (the int8 yardstick); None when it takes none of them."""
    qu = torch.ones((b, q_items.shape[1]), dtype=torch.int8, device=q_items.device)
    forms = (
        lambda a, q: torch._int_mm(a, q.T),
        lambda a, q: torch._int_mm(q, a.T).T,
        lambda a, q: torch._int_mm(a, q.T.contiguous()),
        lambda a, q: torch._int_mm(q, a.T.contiguous()).T,
    )
    for n, form in enumerate(forms):
        try:
            form(qu, q_items)
            torch.cuda.synchronize()
            log(f"int8 yardstick: torch._int_mm form {n}")
            return form
        except RuntimeError as e:   # cuBLASLt refuses the layout
            log(f"int8 yardstick: torch._int_mm form {n} refused: {str(e)[:160]}")
    return None


def fail(msg):
    raise AssertionError(msg)


def check_topk_ids(torch, name, users, items, vals, ids, pvals, mask, tol):
    """Values agree position by position within ``tol``; each returned id's
    own score (recomputed in f64) equals the value beside it; no excluded
    id is returned with a real score."""
    err = float((vals - pvals).abs().max())
    if not err <= tol:
        fail(f"{name}: max abs value error {err} > {tol}")
    real = vals > torch.finfo(torch.float32).min
    own = (users.double()[:, None, :] * items.double()[ids.long()]).sum(-1)
    own_err = float(((own - vals.double()).abs() * real).max())
    if not own_err <= max(tol, 1e-6) + 1e-6:
        fail(f"{name}: returned ids do not carry their values ({own_err})")
    if mask is not None:
        hit = mask.gather(1, ids.long()) != 0
        if bool((hit & real).any()):
            fail(f"{name}: an excluded item was returned")
    return err


def segsum_options(torch, sp, graph, tables, dev, d):
    """Kernel A's layout options, timed on both directions in both modes:
    source windows of several shares of L2 (0: one window, the first
    design's layout) for the to_item direction, whose source table is
    larger than L2, and the lanes a piece runs on (8: four pieces side by
    side in a warp at D=32; 32: a warp each)."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    eu, ei, ew, eu_im, ei_im, ew_im = graph.host_arrays()
    rows = []
    for bf16 in (False, True):
        row_bytes = d * (2 if bf16 else 4)
        cases = [("to_user", 0, (eu, ei, ew, graph.num_users, graph.num_items))]
        cases += [("to_item", share, (ei_im, eu_im, ew_im, graph.num_items, graph.num_users))
                  for share in WINDOW_SHARES]
        for dname, share, (dst, src, w, nrows, nsrc) in cases:
            plan = sp.PallasSegmentPlan.from_edges(
                dst, src, w, nrows, device=dev, num_src_rows=nsrc,
                window_rows=int(share * l2) // row_bytes)
            for lanes in (8, 32):
                p = dataclasses.replace(plan, piece_lanes=lanes)
                rows.append(dict(direction=dname, bf16=bf16, share=share,
                                 windows=p.num_windows, pieces=int(p.piece_row.shape[0]),
                                 piece_lanes=lanes, planned=lanes == plan.piece_lanes,
                                 ms=time_ms(torch, lambda: sp.pallas_segment_sum(
                                     p, tables[dname], bf16), 10)))
                log("segsum option:", json.dumps(rows[-1]))
            del plan, p
    return rows


def trace(torch, fn):
    """Device time per kernel name under torch.profiler over one call of
    ``fn``, and the device's idle share of that call's host wall time (the
    wall taken on an unprofiled call, after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            kernels[ev.key[:80]] = dict(ms=dev_us / 1e3, calls=ev.count)
    busy = sum(k["ms"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:16])
    out = dict(wall_ms=wall_ms, device_busy_ms=busy, device_idle_share=1.0 - busy / wall_ms,
               top=top)
    log("trace:", json.dumps(out))
    return out


class PlainCalls:
    """Counts calls of kernel A's plain version while it is installed, so a
    run can show that a path never fell back on it."""

    def __init__(self, sp):
        self.sp, self.calls, self.real = sp, 0, sp.pallas_segment_sum_plain

    def __enter__(self):
        def counted(*a, **k):
            self.calls += 1
            return self.real(*a, **k)
        self.sp.pallas_segment_sum_plain = counted
        return self

    def __exit__(self, *exc):
        self.sp.pallas_segment_sum_plain = self.real


def kernel_categories(top):
    """Kernel time of a trace by what it does, from the kernel names."""
    groups = {}
    for name, v in top.items():
        n = name.lower()
        kind = ("kernel A" if "segsum" in n else
                "Adam (foreach)" if "multi_tensor_apply" in n else
                "sampling draws" if ("distribution" in n or "philox" in n or "random" in n) else
                "gathers and scatters" if ("index" in n or "gather" in n or "scatter" in n) else
                "reductions" if "reduce" in n else "elementwise and other")
        g = groups.setdefault(kind, dict(ms=0.0, calls=0))
        g["ms"] += v["ms"]
        g["calls"] += v["calls"]
    return groups


def train_phase(torch, data, dev, record):
    """Phase 5: gradients through kernel A against its plain version, a
    timed train step, and ``train()`` end to end with a resume."""
    from laplace_gnn_recommendation_tpu_torch import _build
    from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
    from laplace_gnn_recommendation_tpu_torch.models.lightgcn import (
        LightGCNParams, bpr_loss, init_lightgcn, lightgcn_forward)
    from laplace_gnn_recommendation_tpu_torch.ops import spmm_pallas as sp
    from laplace_gnn_recommendation_tpu_torch.ops.multiscale import self_adjoint_multiscale
    from laplace_gnn_recommendation_tpu_torch.ops.sampling import sample_bpr_batch
    from laplace_gnn_recommendation_tpu_torch.ops.spmm import lightgcn_propagate
    from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import (
        _user_row_ptr, make_train_step, select_propagation, train)

    cfg = LightGCNConfig(**TRAIN_CFG)
    graph, k_iter = data.train_graph, cfg.num_iterations
    prop = select_propagation(cfg, graph)
    if not (isinstance(prop, sp.PallasGraph) and prop.gather_bf16):
        fail("training: propagation='auto' did not take kernel A's bf16-gather mode")
    modes = {"bf16": prop, "f32": sp.PallasGraph.from_graph(graph, width=cfg.hidden_layer_size)}
    gen = torch.Generator(device=dev).manual_seed(11)
    params = init_lightgcn(NUM_USERS, NUM_ITEMS, cfg.hidden_layer_size, generator=gen, device=dev)
    row_ptr = _user_row_ptr(graph)
    max_deg = int(graph.user_deg.max())
    u, pos, neg = (x.long() for x in sample_bpr_batch(
        gen, graph.edge_user, graph.edge_item, graph.num_edges, cfg.batch_size, row_ptr,
        graph.edge_item, NUM_ITEMS, max_deg))
    out = {}

    # ---- 5a. one batch's gradients: kernel A against its plain version ----
    def plain_propagate(pg, eu, ei):
        return (sp.pallas_segment_sum_plain(pg.to_user, ei, pg.gather_bf16),
                sp.pallas_segment_sum_plain(pg.to_item, eu, pg.gather_bf16))

    def grads(loop):
        e0 = LightGCNParams(params.user_emb.detach().clone().requires_grad_(),
                            params.item_emb.detach().clone().requires_grad_())
        uf, itf = loop(e0.user_emb, e0.item_emb)
        loss = bpr_loss(uf[u], e0.user_emb[u], itf[pos], e0.item_emb[pos], itf[neg],
                        e0.item_emb[neg], cfg.Lambda, cfg.bpr_variant)
        return torch.autograd.grad(loss, (e0.user_emb, e0.item_emb))

    in_batch_u = torch.zeros(NUM_USERS, dtype=torch.bool, device=dev)
    in_batch_u[u] = True
    in_batch_i = torch.zeros(NUM_ITEMS, dtype=torch.bool, device=dev)
    in_batch_i[pos] = True
    in_batch_i[neg] = True
    grad_err = {}

    def hold(name, got, ref, tol):
        for table, g, r, in_batch in zip(("user", "item"), got, ref, (in_batch_u, in_batch_i)):
            scale = float(r.abs().max())
            err = float((g - r).abs().max())
            grad_err[f"{name}_{table}"] = dict(max_abs_err=err, ref_max=scale, tol=tol * scale)
            if not (scale > 0 and err <= tol * scale):
                fail(f"training gradients {name} {table}: max abs err {err} > {tol} x {scale}")
            # rows outside the batch get a gradient only through the diffusion
            reached = int(((g != 0).any(1) & ~in_batch).sum())
            ref_reached = int(((r != 0).any(1) & ~in_batch).sum())
            grad_err[f"{name}_{table}"].update(diffusion_rows=reached, ref_diffusion_rows=ref_reached)
            if ref_reached == 0 or reached < 0.99 * ref_reached:
                fail(f"training gradients {name} {table}: {reached} rows outside the batch "
                     f"reached, the reference {ref_reached}")

    for mode, pg in modes.items():
        _build.launches.clear()
        with PlainCalls(sp) as plain_calls:
            g_kernel = grads(lambda a, b: self_adjoint_multiscale(
                sp.propagate_pallas, pg, a, b, k_iter))
            torch.cuda.synchronize()
        if _build.launches["segsum"] != 4 * k_iter or plain_calls.calls:
            fail(f"training gradients {mode}: {_build.launches['segsum']} kernel A launches, "
                 f"{plain_calls.calls} plain calls (expected {4 * k_iter} and 0)")
        g_plain = grads(lambda a, b: self_adjoint_multiscale(plain_propagate, pg, a, b, k_iter))
        hold(f"{mode}_vs_plain_function", g_kernel, g_plain,
             TOL_GRAD_BF16 if pg.gather_bf16 else TOL_GRAD_F32)
        if mode == "f32":
            # plain autograd through ops/spmm.py: the self-adjoint identity,
            # checked independently of the Function
            g_auto = grads(lambda a, b: lightgcn_propagate(graph, a, b, k_iter))
            hold("f32_vs_plain_autograd", g_kernel, g_auto, TOL_GRAD_F32)
            del g_auto
        del g_kernel, g_plain
    log("training gradients:", json.dumps(grad_err))
    out["grad_check"] = grad_err
    del modes

    # ---- 5b. one timed train step (make_train_step) -------------------------
    step, tx = make_train_step(cfg, graph, max_deg, prop_graph=prop, device=dev)
    tparams = init_lightgcn(NUM_USERS, NUM_ITEMS, cfg.hidden_layer_size, generator=gen, device=dev)
    state = [tx.init(tparams)]

    def one_step():
        _, state[0], loss = step(tparams, state[0], gen)
        return loss

    one_step()
    torch.cuda.synchronize()
    _build.launches.clear()
    with PlainCalls(sp) as plain_calls:
        loss0 = one_step()
        torch.cuda.synchronize()
    step_launches = _build.launches["segsum"]
    if step_launches != 4 * k_iter or plain_calls.calls:
        fail(f"train step: {step_launches} kernel A launches and {plain_calls.calls} plain "
             f"calls (expected {4 * k_iter} and 0)")
    if not bool(torch.isfinite(loss0)):
        fail("train step: non-finite loss")
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    one_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    step_dev_ms, step_host_ms = device_ms(torch, one_step, 10, "lightgcn train step")
    step_call_ms = time_ms(torch, one_step, 10)
    # the step's phases, each issued alone on the same inputs
    def sample():
        return sample_bpr_batch(gen, graph.edge_user, graph.edge_item, graph.num_edges,
                                cfg.batch_size, row_ptr, graph.edge_item, NUM_ITEMS, max_deg)

    def forward_loss():
        e0 = LightGCNParams(tparams.user_emb.detach().requires_grad_(),
                            tparams.item_emb.detach().requires_grad_())
        uf, u0, itf, it0 = lightgcn_forward(e0, prop, k_iter)
        return e0, bpr_loss(uf[u], u0[u], itf[pos], it0[pos], itf[neg], it0[neg],
                            cfg.Lambda, cfg.bpr_variant)

    def forward_backward():
        e0, loss = forward_loss()
        return torch.autograd.grad(loss, (e0.user_emb, e0.item_emb))

    g_fixed = LightGCNParams(*forward_backward())
    adam_state = [tx.init(tparams)]

    def adam():
        adam_state[0] = tx.update_(g_fixed, adam_state[0], tparams)

    phases = {name: device_ms(torch, fn, 10, f"lightgcn step phase {name}")[0] for name, fn in (
        ("sampling", sample), ("forward_and_loss", lambda: forward_loss()[1]),
        ("forward_and_backward", forward_backward), ("adam", adam))}
    phases["backward"] = phases["forward_and_backward"] - phases["forward_and_loss"]
    with torch.no_grad():
        phases["kernel_a_forward_only"] = device_ms(
            torch, lambda: lightgcn_forward(tparams, prop, k_iter), 10)[0]
    del g_fixed, adam_state
    tr = trace(torch, one_step)
    out["step"] = dict(
        device_ms=step_dev_ms, call_ms=step_call_ms, host_ms=step_host_ms,
        kernel_a_launches=step_launches, plain_calls=plain_calls.calls,
        peak_allocated_bytes=peak, allocated_before_bytes=base_mem,
        phases_device_ms=phases, trace=tr, trace_by_kind=kernel_categories(tr["top"]),
        batch=cfg.batch_size,
    )
    log("train step:", json.dumps(out["step"]))
    del step, tparams, state

    # ---- 5c. train() end to end, twice with one seed, then a resume ---------
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    run_cfg = dataclasses.replace(cfg, epochs=TRAIN_STEPS, eval_every=TRAIN_EVAL_EVERY,
                                  checkpoint_every=TRAIN_CKPT_EVERY, artifact_dir=TRAIN_DIR,
                                  seed=42)
    logs = []
    _build.launches.clear()
    t0 = time.perf_counter()
    with PlainCalls(sp) as plain_calls:
        s1 = train(run_cfg, data, export=False, log_fn=lambda m: logs.append(str(m)), device=dev)
        torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    run_launches = _build.launches["segsum"]
    for m in logs:
        log("  train:", m)
    s2 = train(run_cfg, data, export=False, log_fn=lambda *_: None, device=dev)
    resume_logs = []
    s3 = train(dataclasses.replace(run_cfg, epochs=TRAIN_STEPS + RESUME_STEPS, resume=True),
               data, export=False, log_fn=lambda m: resume_logs.append(str(m)), device=dev)
    for m in resume_logs:
        log("  resume:", m)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    curve = s1.loss_curve
    floor = 12 / NUM_ITEMS
    out["train"] = dict(
        steps=TRAIN_STEPS, wall_s=t_run, kernel_a_launches=run_launches,
        plain_calls=plain_calls.calls, loss_curve=curve,
        val_recall_at_12=s1.recall_val, val_precision_at_12=s1.precision_val,
        test_recall_at_12=s1.recall_test, test_precision_at_12=s1.precision_test,
        random_recall_floor=floor, same_seed_equal=s1.loss_curve == s2.loss_curve,
        resumed_steps=len(s3.loss_curve), resumed_loss_curve=s3.loss_curve,
        resumed_test_recall_at_12=s3.recall_test,
    )
    log("train:", json.dumps(out["train"]))
    if not np.isfinite(curve).all() or not np.isfinite(s3.loss_curve).all():
        fail("train(): non-finite losses")
    if not np.mean(curve[-5:]) < curve[0]:
        fail(f"train(): mean of the last 5 losses {np.mean(curve[-5:])} not below the first {curve[0]}")
    if not s1.recall_test > floor:
        fail(f"train(): test recall@12 {s1.recall_test} not above the random floor {floor}")
    if s1.loss_curve != s2.loss_curve or s1.recall_test != s2.recall_test:
        fail("train(): two runs of one seed differ")
    if plain_calls.calls or run_launches <= 0:
        fail(f"train(): {run_launches} kernel A launches, {plain_calls.calls} plain calls")
    start = TRAIN_STEPS - TRAIN_STEPS % TRAIN_CKPT_EVERY
    start = start if start < TRAIN_STEPS else start - TRAIN_CKPT_EVERY
    if not any(f"Resuming from checkpoint (iteration {start + 1})" in m for m in resume_logs) \
            or len(s3.loss_curve) != TRAIN_STEPS + RESUME_STEPS - start - 1:
        fail(f"train(): the resume did not continue from the checkpoint of iteration {start}")
    record["training"] = out
    return out

def dense_phase(torch, dev, record):
    """Phase 6: the dense tier at MovieLens-1M shape."""
    from laplace_gnn_recommendation_tpu_torch import _build
    from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
    from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import create_lightgcn_data
    from laplace_gnn_recommendation_tpu_torch.data.synthetic import movielens_like_edges
    from laplace_gnn_recommendation_tpu_torch.models.lightgcn import (
        LightGCNParams, init_lightgcn, lightgcn_forward)
    from laplace_gnn_recommendation_tpu_torch.ops import spmm_dense as sd
    from laplace_gnn_recommendation_tpu_torch.ops import spmm_pallas as sp
    from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import (
        make_train_step, select_propagation)

    t0 = time.perf_counter()
    eu, ei, nu, ni = movielens_like_edges(seed=0)
    data = create_lightgcn_data(eu, ei, nu, ni, device=dev)
    graph = data.train_graph
    t_data = time.perf_counter() - t0
    cfg = LightGCNConfig()   # D=32, K=4, propagation="auto", dense_bytes_budget 4 GiB
    t0 = time.perf_counter()
    dense = select_propagation(cfg, graph)
    t_build = time.perf_counter() - t0
    if not isinstance(dense, sd.DenseAdjacency):
        fail(f"dense tier: propagation='auto' picked {type(dense).__name__} at ML-1M shape")
    gen = torch.Generator(device=dev).manual_seed(3)
    params = init_lightgcn(nu, ni, cfg.hidden_layer_size, generator=gen, device=dev)
    k_iter = cfg.num_iterations

    _build.launches.clear()
    uf, _, itf, _ = lightgcn_forward(params, dense, k_iter)
    torch.cuda.synchronize()
    fwd_launches = dict(_build.launches)
    if uf.dtype != torch.float32 or not (torch.isfinite(uf).all() and torch.isfinite(itf).all()):
        fail("dense tier: the forward is not finite f32")
    # the same tier on the CPU (bf16 operands upcast, f32 products)
    cpu_dense = sd.DenseAdjacency(dense.a.cpu(), dense.a_t.cpu(), nu, ni)
    cuf, _, citf, _ = lightgcn_forward(
        LightGCNParams(params.user_emb.cpu(), params.item_emb.cpu()), cpu_dense, k_iter)
    cpu_err = max(float((uf.cpu() - cuf).abs().max()), float((itf.cpu() - citf).abs().max()))
    if not cpu_err <= TOL_DENSE_CPU:
        fail(f"dense tier: card and CPU differ by {cpu_err} > {TOL_DENSE_CPU}")
    puf, _, pitf, _ = lightgcn_forward(params, graph, k_iter)
    atol, rtol = TOL_DENSE_VS_PLAIN
    plain_err = max(float((uf - puf).abs().max()), float((itf - pitf).abs().max()))
    for out, ref in ((uf, puf), (itf, pitf)):
        if float(((out - ref).abs() - (atol + rtol * ref.abs())).max()) > 0:
            fail(f"dense tier: beyond atol {atol} + rtol {rtol} of the plain f32 forward")
    kernel_a = sp.PallasGraph.from_graph(graph, width=cfg.hidden_layer_size)

    def fwd(op):
        return lambda: lightgcn_forward(params, op, k_iter)

    timing = {}
    for name, op in (("dense", dense), ("kernel_a_f32", kernel_a), ("plain", graph)):
        d_ms, h_ms = device_ms(torch, fwd(op), 10, f"ML-1M forward {name}")
        timing[name] = dict(device_ms=d_ms, host_ms=h_ms, call_ms=time_ms(torch, fwd(op), 10))
    max_deg = int(graph.user_deg.max())
    step, tx = make_train_step(cfg, graph, max_deg, prop_graph=dense, device=dev)
    state = [tx.init(params)]

    def one_step():
        _, state[0], loss = step(params, state[0], gen)
        return loss

    one_step()
    _build.launches.clear()
    loss = one_step()
    torch.cuda.synchronize()
    step_launches = dict(_build.launches)
    if not bool(torch.isfinite(loss)):
        fail("dense tier: non-finite train-step loss")
    step_dev, step_host = device_ms(torch, one_step, 10, "ML-1M dense train step")
    out = dict(
        users=nu, items=ni, train_edges=int(graph.num_edges), data_s=t_data,
        dense_build_s=t_build,
        forward_launches=fwd_launches, step_launches=step_launches,
        max_abs_err_vs_cpu=cpu_err, tol_vs_cpu=TOL_DENSE_CPU,
        max_abs_err_vs_plain_f32=plain_err, tol_vs_plain=f"atol {atol} + rtol {rtol}",
        forward=timing, step_device_ms=step_dev, step_host_ms=step_host,
        step_call_ms=time_ms(torch, one_step, 10),
        kernel_a_faster=timing["kernel_a_f32"]["device_ms"] < timing["dense"]["device_ms"],
    )
    if any(fwd_launches.values()) or any(step_launches.values()):
        fail(f"dense tier launched kernels: {fwd_launches} {step_launches}")
    log("dense:", json.dumps(out))
    record["dense"] = out
    return out


def ranking_phase(torch, dev, record):
    """Phase 7: the ranking stack at ``Config``'s widths."""
    import copy
    import itertools

    import torch.nn.functional as F

    from laplace_gnn_recommendation_tpu_torch import _build, native
    from laplace_gnn_recommendation_tpu_torch.configs import Config
    from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import (
        create_link_pred_data, create_samplers)
    from laplace_gnn_recommendation_tpu_torch.data.prefetch import prefetch
    from laplace_gnn_recommendation_tpu_torch.data.sampler import parallel_epoch_batches
    from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
    from laplace_gnn_recommendation_tpu_torch.models import sage
    from laplace_gnn_recommendation_tpu_torch.serving import RankingServer
    from laplace_gnn_recommendation_tpu_torch.train import encdec_pipeline as ep
    from laplace_gnn_recommendation_tpu_torch.train.adam import Adam
    from laplace_gnn_recommendation_tpu_torch.train.checkpoint import tree_leaves_with_path

    out = {}
    t0 = time.perf_counter()
    built = native.available()
    out["native_build_s"] = time.perf_counter() - t0
    if not built:
        fail("the native sampler library did not build")
    out["native_library"] = os.path.relpath(native.library_path())

    t0 = time.perf_counter()
    g = random_hetero_graph(seed=0, num_users=RANK_USERS, num_items=RANK_ITEMS,
                            avg_degree=RANK_DEGREE, num_user_features=2, num_item_features=2,
                            feature_cardinality=RANK_FEATURE_CARD)
    cfg = Config(**RANK_CFG)
    data = create_link_pred_data(g, cfg, device=dev)
    out["data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_s, _, test_s = create_samplers(cfg, data, seed=0)
    out["samplers_s"] = time.perf_counter() - t0
    if train_s._native is None:
        fail("the train sampler is not on the native path")
    bud = train_s.budgets
    use_dense = 0 < 2 * bud.num_user_slots * bud.num_item_slots * 4 <= cfg.dense_bytes_budget
    out.update(budgets=dataclasses.asdict(bud), dense_subgraph_path=use_dense,
               train_edges=int(data.splits["train"].user_csr.cols.shape[0]))
    log("ranking data:", json.dumps(out))

    # sampler batches/s, 1 and 2 workers
    rng = np.random.default_rng(0)
    train_s.sample_batch(rng.integers(0, RANK_USERS, cfg.batch_size))
    t0 = time.perf_counter()
    edges = 0
    for _ in range(RANK_TIMED_BATCHES):
        edges += int(train_s.sample_batch(rng.integers(0, RANK_USERS, cfg.batch_size)).edge_mask.sum())
    out["sampler_batches_per_s_1_worker"] = RANK_TIMED_BATCHES / (time.perf_counter() - t0)
    out["edges_per_batch"] = edges / RANK_TIMED_BATCHES
    it = parallel_epoch_batches(train_s, num_workers=2, shuffle=True)
    next(it)
    t0 = time.perf_counter()
    for _ in itertools.islice(it, RANK_TIMED_BATCHES):
        pass
    out["sampler_batches_per_s_2_workers"] = RANK_TIMED_BATCHES / (time.perf_counter() - t0)
    it.close()

    # one train step
    gen = torch.Generator(device=dev).manual_seed(0)
    params, bn_state = sage.init_sage_params(cfg, sage.get_feature_info(data.graph),
                                             float_dims=data.float_dims(), generator=gen,
                                             device=dev)
    tx = Adam(cfg.learning_rate)
    st = dict(bn=bn_state, opt=tx.init(sage.jax_tree(params)))
    step = ep.make_train_step(cfg, data, tx)
    b0 = train_s.sample_batch(rng.integers(0, RANK_USERS, cfg.batch_size)).to(dev)

    def one_step():
        _, st["bn"], st["opt"], loss = step(params, st["bn"], st["opt"], b0, gen)
        return loss

    one_step()
    torch.cuda.synchronize()
    _build.launches.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    loss0 = one_step()
    torch.cuda.synchronize()
    out["step_launches"] = dict(_build.launches)
    out["step_peak_bytes_above_start"] = torch.cuda.max_memory_allocated(dev) - base_mem
    out["step_start_bytes"] = base_mem
    if not bool(torch.isfinite(loss0)):
        fail("ranking train step: non-finite loss")
    out["step_device_ms"], out["step_host_ms"] = device_ms(torch, one_step, 10,
                                                            "ranking train step")
    out["step_call_ms"] = time_ms(torch, one_step, 10)
    tr = trace(torch, one_step)
    out["step_trace"] = dict(wall_ms=tr["wall_ms"], device_busy_ms=tr["device_busy_ms"],
                             device_idle_share=tr["device_idle_share"],
                             by_kind=kernel_categories(tr["top"]))

    # the step's row gathers (sorted segment sums as their backward) against
    # the library's: kernel time of the step, and whether one batch's
    # gradients come out the same bits twice
    def grads_repeat():
        grads = []
        for _ in range(2):
            for p_ in params.parameters():
                p_.grad = None
            gen.manual_seed(11)
            logits, _ = sage.forward(params, st["bn"], b0, data.user_features,
                                     data.item_features, cfg, train=True, generator=gen)
            sage.bce_loss(logits, b0).backward()
            grads.append(torch.cat([p_.grad.flatten() for p_ in params.parameters()]))
        return bool(torch.equal(*grads))

    ours, gathers = sage._rows, {}
    for name, fn in (("sorted_sum", ours),
                     ("F.embedding", lambda t, i, plan=None: F.embedding(i, t)),
                     ("table[idx]", lambda t, i, plan=None: t[i])):
        sage._rows = fn
        try:
            gathers[name] = dict(step_device_busy_ms=trace(torch, one_step)["device_busy_ms"],
                                 step_call_ms=time_ms(torch, one_step, 10),
                                 grads_repeat=grads_repeat())
        finally:
            sage._rows = ours
    out["step_gathers"] = gathers
    if not gathers["sorted_sum"]["grads_repeat"]:
        fail("ranking step: one batch's gradients differ between two identical passes")

    # train users/s: sampler + prefetch (upload on its thread) + step
    chunks = train_s.epoch_user_chunks(shuffle=True)[:RANK_TIMED_BATCHES]
    feed = (train_s.sample_batch(c, valid_rows=v) for c, v in chunks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in prefetch(feed, buffer_size=2, transform=lambda x: x.to(dev)):
        step(params, st["bn"], st["opt"], b, gen)
    torch.cuda.synchronize()
    out["train_users_per_s"] = sum(v for _, v in chunks) / (time.perf_counter() - t0)

    # eval users/s through the native eval assembly + infer
    eval_step = ep.make_eval_step(cfg, data)
    chunks = test_s.epoch_user_chunks(shuffle=False)[: RANK_TIMED_BATCHES // 3 + 1]
    batches = prefetch((test_s.sample_batch(c, valid_rows=v) for c, v in chunks),
                       buffer_size=2, transform=lambda x: x.to(dev))
    eval_step(params, st["bn"], next(batches))   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = [eval_step(params, st["bn"], b)[0] for b in batches]
    torch.cuda.synchronize()
    out["eval_users_per_s"] = sum(v for _, v in chunks[1:]) / (time.perf_counter() - t0)
    out["eval_recall_at_12_random_weights"] = float(torch.stack(recs).mean())

    # RankingServer.recommend for 1,000 users
    server = RankingServer(cfg, data, params, st["bn"])
    warm = np.flatnonzero(server.sampler.users.degrees > 0)
    req = np.random.default_rng(1).choice(warm, RANK_SERVE_USERS, replace=False)
    server.recommend(req[: cfg.batch_size])
    _build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = server.recommend(req)
    out["recommend_1000_users_s"] = time.perf_counter() - t0
    out["recommend_launches"] = dict(_build.launches)
    if ids.shape != (RANK_SERVE_USERS, cfg.k) or (ids >= RANK_ITEMS).any() or (ids < -1).any():
        fail("RankingServer: bad output")
    seen_csr = data.splits["test"].user_csr
    filled = 0
    for row, u in zip(ids, req):
        got = row[row >= 0]
        filled += len(got)
        if len(set(got.tolist())) != len(got) or np.isin(got, seen_csr.neighbors(int(u))).any():
            fail(f"RankingServer: user {u} got a duplicate or an already-seen item")
    out["recommend_filled_share"] = filled / ids.size
    log("ranking:", json.dumps(out))

    # one max-aggregation step (the segment path) against f64 on the CPU
    cfg_max = dataclasses.replace(cfg, conv_agg_type="max", p_dropout_features=0.0)
    bmax = train_s.sample_batch(rng.integers(0, RANK_USERS, cfg.batch_size))
    # fresh weights: the trained ones have drifted to large pre-BatchNorm
    # activations, whose mean subtraction cancels digits in f32
    mparams, mbn = sage.init_sage_params(cfg_max, sage.get_feature_info(data.graph),
                                         generator=torch.Generator(device=dev).manual_seed(7),
                                         device=dev)
    ref_model = copy.deepcopy(mparams).to("cpu", torch.float64)
    ref_bn = {t: {k: v.cpu().double() for k, v in s.items()} for t, s in mbn.items()}
    results = {}
    for name, model, bn, d in (("card", mparams, mbn, data), ("cpu_f64", ref_model, ref_bn, None)):
        uf = data.user_features if d is not None else data.user_features.cpu()
        itf = data.item_features if d is not None else data.item_features.cpu()
        for p_ in model.parameters():
            p_.grad = None
        logits, _ = sage.forward(model, bn, bmax.to(uf.device), uf, itf, cfg_max, train=True)
        sage.bce_loss(logits, bmax.to(uf.device)).backward()
        results[name] = (logits.detach().cpu().double(),
                         {k: v.detach().cpu().double()
                          for k, v in tree_leaves_with_path(sage.grad_tree(model))})
    lg, gr = results["card"]
    rlg, rgr = results["cpu_f64"]
    logit_err = float((lg - rlg).abs().max())
    logit_tol = TOL_RANK_LOGITS * (1 + float(rlg.abs().max()))
    g_all = torch.cat([gr[k].flatten() for k in sorted(rgr)])
    r_all = torch.cat([rgr[k].flatten() for k in sorted(rgr)])
    grad_rel = float((g_all - r_all).norm() / r_all.norm())
    out["max_step"] = dict(
        logits_max_abs_err=logit_err, logits_tol=logit_tol, grad_rel_l2_err=grad_rel,
        grad_tol=TOL_RANK_GRAD, grad_max_abs_err=float((g_all - r_all).abs().max()),
        grad_largest=float(r_all.abs().max()), edges=int(bmax.edge_mask.sum()))
    log("ranking max step:", json.dumps(out["max_step"]))
    if not (logit_err <= logit_tol and grad_rel <= TOL_RANK_GRAD):
        fail(f"max-aggregation step differs from f64 on the CPU: {out['max_step']}")
    del ref_model, mparams, server, data, train_s, test_s, params

    # run_pipeline at the same widths on a smaller graph: dense and segment
    # subgraph paths, each twice with one seed, then a resume leg
    gp = random_hetero_graph(seed=1, num_users=PIPE_USERS, num_items=PIPE_ITEMS,
                             avg_degree=RANK_DEGREE, num_user_features=2, num_item_features=2,
                             feature_cardinality=RANK_FEATURE_CARD)
    runs = {}
    for path, budget in (("dense", cfg.dense_bytes_budget), ("segment", 0)):
        pcfg = dataclasses.replace(cfg, epochs=PIPE_EPOCHS, eval_every=1, save_model=True,
                                   save_every=1.0 / PIPE_EPOCHS, dense_bytes_budget=budget)
        pdata = create_link_pred_data(gp, pcfg, device=dev)
        pb = create_samplers(pcfg, pdata, seed=pcfg.seed)[0].budgets
        took_dense = 0 < 2 * pb.num_user_slots * pb.num_item_slots * 4 <= budget
        if took_dense != (path == "dense"):
            fail(f"run_pipeline {path}: the subgraph path is not the one asked for ({pb})")
        legs = []
        for leg in range(2):
            shutil.rmtree(PIPE_DIR, ignore_errors=True)
            _build.launches.clear()
            t0 = time.perf_counter()
            stats = ep.run_pipeline(pcfg, pdata, model_dir=PIPE_DIR, log_fn=lambda *_: None,
                                    device=dev)
            torch.cuda.synchronize()
            legs.append(dict(wall_s=time.perf_counter() - t0, loss_curve=stats.loss_curve,
                             val_recall_at_12=stats.recall_val,
                             val_precision_at_12=stats.precision_val,
                             test_recall_at_12=stats.recall_test,
                             test_precision_at_12=stats.precision_test,
                             truncations=stats.truncations, launches=dict(_build.launches)))
        logs = []
        resumed = ep.run_pipeline(dataclasses.replace(pcfg, epochs=PIPE_EPOCHS + 1), pdata,
                                  model_dir=PIPE_DIR, log_fn=lambda m: logs.append(str(m)),
                                  resume=True, device=dev)
        shutil.rmtree(PIPE_DIR, ignore_errors=True)
        a, b = legs
        spread = float(np.max(np.abs(np.subtract(a["loss_curve"], b["loss_curve"]))))
        runs[path] = dict(
            budgets=dataclasses.asdict(pb), runs=legs, same_seed_equal=a["loss_curve"] == b["loss_curve"]
            and a["test_recall_at_12"] == b["test_recall_at_12"],
            loss_curve_max_abs_spread=spread,
            test_recall_spread=abs(a["test_recall_at_12"] - b["test_recall_at_12"]),
            resumed=any(f"Resuming from checkpoint (epoch {PIPE_EPOCHS})" in m for m in logs),
            resumed_loss_curve=resumed.loss_curve, resumed_test_recall_at_12=resumed.recall_test,
        )
        log(f"run_pipeline {path}:", json.dumps(runs[path]))
        curve = a["loss_curve"]
        if len(curve) != PIPE_EPOCHS or not np.isfinite(curve).all() or not curve[-1] < curve[0]:
            fail(f"run_pipeline {path}: loss curve {curve}")
        if not (runs[path]["resumed"] and len(resumed.loss_curve) == 1):
            fail(f"run_pipeline {path}: the resume leg did not continue at epoch {PIPE_EPOCHS}")
        if any(any(leg["launches"].values()) for leg in legs):
            fail(f"run_pipeline {path} launched kernels")
    out["run_pipeline"] = runs
    record["ranking"] = out
    return out


def write_movielens(raw_dir, seed=0):
    """ml-1m-format ``users.dat``, ``movies.dat`` and ``ratings.dat`` at
    MovieLens-1M's published size (6,040 users, 3,883 movies, 1,000,209
    ratings, at least 20 a user), with the structure of
    ``tests/test_acceptance_movielens.py``'s files: each user prefers one
    genre and draws 80% of its ratings from the movies that carry it.
    Timestamps interleave the users, as the real files do."""
    rng = np.random.default_rng(seed)
    genres = ["Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
              "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical", "Mystery",
              "Romance", "Sci-Fi", "Thriller", "War", "Western"]
    ng = len(genres)
    os.makedirs(raw_dir, exist_ok=True)
    ages = (1, 18, 25, 35, 45, 50, 56)
    with open(os.path.join(raw_dir, "users.dat"), "w") as f:
        for u in range(1, ML_USERS + 1):
            f.write(f"{u}::{'FM'[u % 2]}::{ages[u % 7]}::{u % 21}::{10000 + u * 7919 % 90000}\n")
    movie_ids = np.arange(1, ML_MOVIES + 1)
    with open(os.path.join(raw_dir, "movies.dat"), "w") as f:
        for i in movie_ids:
            f.write(f"{i}::Movie {i} ({1919 + i % 82})::{genres[i % ng]}|{genres[(i + 5) % ng]}\n")
    weights = rng.lognormal(0.0, 0.8, ML_USERS)   # the largest user near ML-1M's 2,314
    counts = np.minimum(20 + rng.multinomial(ML_RATINGS - 20 * ML_USERS,
                                             weights / weights.sum()), ML_MOVIES)
    # what the cap took goes to the users with the most room, in turn
    room = ML_MOVIES - counts
    order = np.argsort(-room, kind="stable")
    before = np.cumsum(room[order]) - room[order]
    counts[order] += np.clip(ML_RATINGS - int(counts.sum()) - before, 0, room[order])
    users, movies = [], []
    for u, n in zip(range(1, ML_USERS + 1), counts):
        g = u % ng
        pool = movie_ids[(movie_ids % ng == g) | ((movie_ids + 5) % ng == g)]
        n_pref = min(int(round(n * 0.8)), len(pool))
        picks = np.unique(np.concatenate([rng.choice(pool, n_pref, replace=False),
                                          rng.choice(movie_ids, n - n_pref, replace=False)]))
        while len(picks) < n:
            picks = np.unique(np.concatenate([picks, rng.choice(movie_ids, n - len(picks),
                                                                replace=False)]))
        users.append(np.full(n, u))
        movies.append(rng.permutation(picks[:n]))
    users, movies = np.concatenate(users), np.concatenate(movies)
    ratings = rng.integers(1, 6, len(users))
    stamps = 956_703_932 + rng.integers(0, 90_000_000, len(users))
    with open(os.path.join(raw_dir, "ratings.dat"), "w") as f:
        f.write("".join(f"{u}::{m}::{r}::{t}\n" for u, m, r, t in zip(
            users.tolist(), movies.tolist(), ratings.tolist(), stamps.tolist())))
    return dict(users=ML_USERS, movies=ML_MOVIES, ratings=int(len(users)))


def pinsage_phase(torch, dev, record, edges):
    """Phase 8: PinSAGE at ``bench_pinsage.py``'s width on phase 3's H&M
    edges, then the artifacts path end to end."""
    import copy

    from laplace_gnn_recommendation_tpu_torch import _build, native
    from laplace_gnn_recommendation_tpu_torch.configs import Config, preprocessing_config
    from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
    from laplace_gnn_recommendation_tpu_torch.data.etl import LinkPredArtifacts
    from laplace_gnn_recommendation_tpu_torch.data.graph import HeteroGraph
    from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import (
        create_link_pred_data_from_artifacts)
    from laplace_gnn_recommendation_tpu_torch.data.pinsage_data import (
        PinSAGESampler, build_pinsage_data)
    from laplace_gnn_recommendation_tpu_torch.data.preprocess_movielens import preprocess
    from laplace_gnn_recommendation_tpu_torch.data.splitting import train_test_split_by_time
    from laplace_gnn_recommendation_tpu_torch.models import pinsage as M
    from laplace_gnn_recommendation_tpu_torch.train import pinsage_pipeline as pp
    from laplace_gnn_recommendation_tpu_torch.train.checkpoint import tree_leaves_with_path
    from laplace_gnn_recommendation_tpu_torch.train.encdec_pipeline import run_pipeline
    from laplace_gnn_recommendation_tpu_torch.train.submission import submission_pipeline

    out = {}
    _build.launches.clear()
    if not native.available():
        fail("PinSAGE: the native sampler library did not build")

    # ---- the H&M graph as PinSAGE data (bench_pinsage.py: one constant
    # categorical item feature; the edges' order is taken as time)
    t0 = time.perf_counter()
    eu, ei = edges
    tr, va, te = train_test_split_by_time(eu)
    g = HeteroGraph(
        node_features={EDGE_KEY.src: np.zeros((NUM_USERS, 1), np.int32),
                       EDGE_KEY.dst: np.zeros((NUM_ITEMS, 1), np.int32)},
        edges={EDGE_KEY: (eu, ei)},
        num_nodes={EDGE_KEY.src: NUM_USERS, EDGE_KEY.dst: NUM_ITEMS},
    )
    data = build_pinsage_data(LinkPredArtifacts(g, tr, va, te, {}, {}))
    out["data_s"] = time.perf_counter() - t0
    out["train_edges"] = int(tr.sum())
    cfg = pp.PinSAGEConfig(**PIN_CFG)
    skw = dict(random_walk_length=cfg.random_walk_length, num_random_walks=cfg.num_random_walks,
               num_neighbors=cfg.num_neighbors, num_layers=cfg.num_layers)

    # ---- walks/s, native and Python frontiers (bench_pinsage.run)
    rng = np.random.default_rng(0)
    for path, n_batches in (("native", PIN_NATIVE_BATCHES), ("python", PIN_PYTHON_BATCHES)):
        s = PinSAGESampler(data, batch_size=cfg.batch_size, seed=1,
                           use_native=path == "native", **skw)
        if s.path != path:
            fail(f"PinSAGE sampler took the {s.path} path, not the {path} one")
        s.neighbor_frontier(rng.integers(0, NUM_ITEMS, cfg.batch_size))
        t0 = time.perf_counter()
        for _ in range(n_batches):
            s.neighbor_frontier(rng.integers(0, NUM_ITEMS, cfg.batch_size))
        out[f"walks_per_s_{path}"] = n_batches * cfg.batch_size * cfg.num_random_walks / (
            time.perf_counter() - t0)
    sampler = PinSAGESampler(data, batch_size=cfg.batch_size, seed=2, **skw)
    sampler.sample_train_batch()
    t0 = time.perf_counter()
    for _ in range(PIN_ASM_BATCHES):
        sampler.sample_train_batch()
    out["train_batches_per_s"] = PIN_ASM_BATCHES / (time.perf_counter() - t0)
    log("pinsage sampling:", json.dumps(out))

    # ---- one dense-Adam step and one sparse_embedding step
    item_features = torch.from_numpy(data.item_features.astype(np.int64)).to(dev)
    host_batch = sampler.sample_train_batch()
    b0 = host_batch.to(dev)
    masks = (host_batch.blocks[0].src_mask, host_batch.blocks[-1].dst_mask)
    out["batch_slots"] = dict(src=int(b0.blocks[0].src_ids.shape[0]),
                              valid_src=int(masks[0].sum()), pairs=int(host_batch.pair_mask.sum()))
    steps = {}
    for mode in ("dense", "sparse"):
        mcfg = dataclasses.replace(cfg, sparse_embedding=mode == "sparse")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = M.init_pinsage_params(NUM_ITEMS, [0], cfg.hidden_dims, cfg.num_layers,
                                       generator=gen, device=dev)
        step, _ = pp.make_train_step(mcfg, params, item_features, None, gen)

        def one_step():
            return step(b0, *masks)

        one_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        loss = one_step()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(loss)):
            fail(f"PinSAGE {mode} step: non-finite loss")
        peak = torch.cuda.max_memory_allocated(dev) - base
        d_ms, h_ms = device_ms(torch, one_step, 10, f"pinsage {mode} train step")
        tr_ = trace(torch, one_step)
        steps[mode] = dict(device_ms=d_ms, host_ms=h_ms, call_ms=time_ms(torch, one_step, 10),
                           idle_share=tr_["device_idle_share"], wall_ms=tr_["wall_ms"],
                           kernel_ms=tr_["device_busy_ms"], peak_bytes_above_start=peak,
                           start_bytes=base, by_kind=kernel_categories(tr_["top"]))
        log(f"pinsage {mode} step:", json.dumps(steps[mode]))
    out["steps"] = steps

    # ---- one batch's gradients twice (bit for bit), and against f64 on the CPU
    def grads(model, batch, itf, seed):
        for p_ in model.parameters():
            p_.grad = None
        gen = None
        if seed is not None:
            gen = torch.Generator(device=itf.device).manual_seed(seed)
        loss = M.margin_loss(model, batch, itf, None, train=seed is not None, generator=gen)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in tree_leaves_with_path(M.grad_tree(model))}

    a = grads(params, b0, item_features, 11)
    b = grads(params, b0, item_features, 11)
    repeat = all(torch.equal(a[1][k], b[1][k]) for k in a[1]) and torch.equal(a[0], b[0])
    out["grads_repeat"] = repeat
    if not repeat:
        fail("PinSAGE: one batch's gradients differ between two identical passes")
    # fresh weights: the timed steps above trained these on one batch
    fresh = M.init_pinsage_params(NUM_ITEMS, [0], cfg.hidden_dims, cfg.num_layers,
                                  generator=torch.Generator(device=dev).manual_seed(7),
                                  device=dev)
    loss32, g32 = grads(fresh, b0, item_features, None)
    ref = copy.deepcopy(fresh).to("cpu", torch.float64)
    loss64, g64 = grads(ref, host_batch.to("cpu"), item_features.cpu(), None)
    g_all = torch.cat([g32[k].cpu().double().flatten() for k in sorted(g64)])
    r_all = torch.cat([g64[k].flatten() for k in sorted(g64)])
    out["f64_check"] = dict(
        loss=float(loss32), loss_f64=float(loss64), loss_abs_err=abs(float(loss32) - float(loss64)),
        loss_tol=TOL_PIN_LOSS * (1 + abs(float(loss64))),
        grad_rel_l2_err=float((g_all - r_all).norm() / r_all.norm()), grad_tol=TOL_PIN_GRAD,
        grad_max_abs_err=float((g_all - r_all).abs().max()), grad_largest=float(r_all.abs().max()))
    log("pinsage f64 check:", json.dumps(out["f64_check"]))
    chk = out["f64_check"]
    if not (abs(float(loss32) - float(loss64)) <= chk["loss_tol"]
            and chk["grad_rel_l2_err"] <= TOL_PIN_GRAD):
        fail(f"PinSAGE margin loss or gradients differ from f64 on the CPU: {chk}")
    del ref, fresh, g64, g32, a, b

    # ---- embed_all_items over the catalog, hits_at_k on 20,000 users
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_item = pp.embed_all_items(cfg, params, data, sampler, item_features, None)
    out["embed_all_items_s"] = time.perf_counter() - t0
    if h_item.shape != (NUM_ITEMS, cfg.hidden_dims) or not np.isfinite(h_item).all():
        fail("embed_all_items: bad output")
    t0 = time.perf_counter()
    out["val_hits_at_10_random_weights"] = pp.hits_at_k(data, h_item, cfg.k, "val",
                                                        user_cap=PIN_HITS_USERS, device=dev)
    out["hits_at_k_s"] = time.perf_counter() - t0
    out["hits_users"] = PIN_HITS_USERS
    out["launches"] = dict(_build.launches)
    log("pinsage:", json.dumps({k: v for k, v in out.items() if k != "steps"}))
    del data, sampler, params, b0, item_features, h_item

    # ---- the artifacts path: raw ml-1m files -> preprocess -> PinSAGE (and a
    # resumed leg); -> the ranking stack -> a submission CSV
    e2e = {}
    shutil.rmtree(ML_DIR, ignore_errors=True)
    raw, art = os.path.join(ML_DIR, "raw"), os.path.join(ML_DIR, "derived")
    t0 = time.perf_counter()
    e2e["raw"] = write_movielens(raw)
    e2e["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # every rating, not the shipped config's first 10,000
    a = preprocess(dataclasses.replace(preprocessing_config, data_size=None), raw, art)
    e2e["preprocess_s"] = time.perf_counter() - t0
    e2e["graph"] = dict(a.graph.num_nodes, edges=int(len(a.graph.edges[EDGE_KEY][0])))
    ckpt = os.path.join(ML_DIR, "pinsage")
    t0 = time.perf_counter()
    cli = pp.run_pinsage_cli(art, checkpoint_dir=ckpt, device=dev)
    e2e["run_pinsage_cli"] = dict(wall_s=time.perf_counter() - t0, loss=cli["loss"],
                                  val_hits=cli["val_hits"], test_hits=cli["test_hits"],
                                  epochs_done=cli["epochs_done"])
    logs = []
    t0 = time.perf_counter()
    resumed = pp.train(pp.PinSAGEConfig(num_epochs=3, batches_per_epoch=200),
                       build_pinsage_data(a), log_fn=lambda m: logs.append(str(m)),
                       checkpoint_dir=ckpt, device=dev)
    e2e["resumed_leg"] = dict(wall_s=time.perf_counter() - t0, loss=resumed["loss"],
                              val_hits=resumed["val_hits"], test_hits=resumed["test_hits"],
                              log=logs)
    if not (cli["completed"] and np.isfinite(cli["loss"]) and 0 <= cli["test_hits"] <= 1):
        fail(f"run_pinsage_cli: {e2e['run_pinsage_cli']}")
    if not (any("[resume] from epoch 2" in m for m in logs) and resumed["completed"]
            and resumed["epochs_done"] == 3 and np.isfinite(resumed["loss"])):
        fail(f"PinSAGE: the resumed leg did not continue from epoch 2: {e2e['resumed_leg']}")
    rcfg = Config(**RANK_CFG, epochs=ML_EPOCHS, eval_every=1, save_model=True, save_every=0.5)
    model_dir = os.path.join(ML_DIR, "model")
    t0 = time.perf_counter()
    rdata, artifacts = create_link_pred_data_from_artifacts(art, rcfg, device=dev)
    stats = run_pipeline(rcfg, rdata, model_dir=model_dir, log_fn=lambda *_: None, device=dev)
    e2e["run_pipeline"] = dict(wall_s=time.perf_counter() - t0, loss_curve=stats.loss_curve,
                               test_recall_at_12=stats.recall_test,
                               test_precision_at_12=stats.precision_test,
                               truncations=stats.truncations)
    t0 = time.perf_counter()
    csv = submission_pipeline(rcfg, rdata, artifacts.customer_id_map_forward,
                              artifacts.article_id_map_forward, model_dir=model_dir,
                              out_path=os.path.join(ML_DIR, "submission.csv"))
    e2e["submission_s"] = time.perf_counter() - t0
    with open(csv) as f:
        lines = f.read().strip().split("\n")
    raw_users = set(map(str, range(1, ML_USERS + 1)))
    raw_movies = set(map(str, range(1, ML_MOVIES + 1)))
    rows = [line.split(",") for line in lines[1:]]
    filled = sum(len(p.split()) for _, p in rows)
    e2e["submission"] = dict(rows=len(rows), predictions=filled, k=rcfg.k)
    e2e["launches"] = dict(_build.launches)
    log("pinsage artifacts path:", json.dumps(e2e))
    curve = stats.loss_curve
    if len(curve) != ML_EPOCHS or not np.isfinite(curve).all():
        fail(f"artifacts path run_pipeline: loss curve {curve}")
    if lines[0] != "customer_id,prediction" or not rows or filled == 0 or any(
            c not in raw_users or len(p.split()) > rcfg.k
            or not set(p.split()) <= raw_movies for c, p in rows):
        fail(f"submission CSV malformed: {lines[:3]}")
    shutil.rmtree(ML_DIR, ignore_errors=True)
    out["artifacts_path"] = e2e
    if any(out["launches"].values()) or any(e2e["launches"].values()):
        fail(f"the PinSAGE path launched kernels: {out['launches']} {e2e['launches']}")
    record["pinsage"] = out
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from laplace_gnn_recommendation_tpu_torch import _build
    from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
    from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import (
        create_lightgcn_data,
        padded_user_items,
    )
    from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
    from laplace_gnn_recommendation_tpu_torch.models.lightgcn import (
        init_lightgcn,
        lightgcn_forward,
    )
    from laplace_gnn_recommendation_tpu_torch.ops import spmm_pallas as sp
    from laplace_gnn_recommendation_tpu_torch.ops.multiscale import multiscale_loop
    from laplace_gnn_recommendation_tpu_torch.ops import topk_pallas as tp
    from laplace_gnn_recommendation_tpu_torch.ops.topk import auto_mips_topk
    from laplace_gnn_recommendation_tpu_torch.serving import RetrievalServer
    from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import (
        select_propagation,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}

    # ---- 1. card + build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    record["nvidia_smi"] = smi
    t0 = time.perf_counter()
    secs = _build.build_all()
    record["build_s"] = time.perf_counter() - t0
    record["build_per_source_s"] = secs
    log(f"build: {record['build_s']:.1f} s wall, per source {secs}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas[{name}] {line.strip()}")

    # ---- data (host) ------------------------------------------------------
    t0 = time.perf_counter()
    eu, ei = random_bipartite_edges(0, NUM_USERS, NUM_ITEMS, AVG_DEGREE, POPULARITY_ALPHA)
    hm_edges = (eu, ei)   # phase 8 takes them again
    t_edges = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the 80/10/10 split (seed 1): one graph per split on the card, eval sets
    data = create_lightgcn_data(eu, ei, NUM_USERS, NUM_ITEMS, device=dev)
    graph = data.train_graph
    train_u, train_i = data.train_edges
    t_graph = time.perf_counter() - t0
    cfg = LightGCNConfig()   # hidden_layer_size=32, num_iterations=4
    cfg.propagation = "auto"
    t0 = time.perf_counter()
    prop = select_propagation(cfg, graph)
    t_plan = time.perf_counter() - t0
    if not isinstance(prop, sp.PallasGraph):
        fail(f"propagation='auto' picked {type(prop).__name__} on the card")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_lightgcn(NUM_USERS, NUM_ITEMS, cfg.hidden_layer_size, generator=gen, device=dev)
    record["data"] = dict(
        edges=int(len(eu)), train_edges=int(graph.num_edges),
        edges_s=t_edges, graph_s=t_graph, plan_s=t_plan,
        max_item_degree=int(graph.item_deg.max()), max_user_degree=int(graph.user_deg.max()),
        slots_to_item=prop.to_item.num_slots, slots_to_user=prop.to_user.num_slots,
        pieces_to_item=int(prop.to_item.piece_row.shape[0]),
        pieces_to_user=int(prop.to_user.piece_row.shape[0]),
    )
    log("data:", json.dumps(record["data"]))

    # ---- 2. kernels against their plain versions ---------------------------
    kern = {}
    atol, rtol = TOL_SEGSUM
    # A in both modes: ``auto`` took the bf16-gather mode at H&M size; the
    # f32 mode (``pallas``) gets its own plans, windows sized for f32 rows
    modes = {"bf16": prop, "f32": sp.PallasGraph.from_graph(graph, width=cfg.hidden_layer_size)}
    if not prop.gather_bf16:
        fail("propagation='auto' did not take the bf16-gather mode at H&M size")
    if modes["f32"].to_item.num_windows < 2 or prop.to_item.num_windows < 2:
        fail("the to_item direction runs in one source window at H&M size")
    tables = {"to_user": params.item_emb, "to_item": params.user_emb}
    a_err = {}
    for mode, pg in modes.items():
        for dname in ("to_user", "to_item"):
            plan = getattr(pg, dname)
            out = sp.pallas_segment_sum(plan, tables[dname], pg.gather_bf16)
            ref = sp.pallas_segment_sum_plain(plan, tables[dname], pg.gather_bf16)
            torch.cuda.synchronize()
            a_err[f"{mode}_{dname}"] = float((out - ref).abs().max())
            if float(((out - ref).abs() - (atol + rtol * ref.abs())).max()) > 0:
                fail(f"segsum {mode} {dname}: beyond atol {atol} + rtol {rtol}")
            again = sp.pallas_segment_sum(plan, tables[dname], pg.gather_bf16)
            if not torch.equal(out, again):
                fail(f"segsum {mode} {dname} is not deterministic from run to run")
            del out, ref, again
    log("segsum max abs err:", json.dumps(a_err))
    # a width whose vector count (25) is not a power of two: 7 of 32 lanes idle
    gen_w = torch.Generator(device=dev).manual_seed(2)
    a_err_wide = 0.0
    for mode, pg in modes.items():
        for dname, rows in (("to_user", NUM_ITEMS), ("to_item", NUM_USERS)):
            table = torch.randn((rows, WIDE_D), generator=gen_w, device=dev) * 0.1
            plan = getattr(pg, dname)
            out = sp.pallas_segment_sum(plan, table, pg.gather_bf16)
            ref = sp.pallas_segment_sum_plain(plan, table, pg.gather_bf16)
            a_err_wide = max(a_err_wide, float((out - ref).abs().max()))
            if float(((out - ref).abs() - (atol + rtol * ref.abs())).max()) > 0:
                fail(f"segsum {mode} D={WIDE_D} {dname}: beyond atol {atol} + rtol {rtol}")
            del table, out, ref
    log(f"segsum D={WIDE_D}: max abs err {a_err_wide}")
    # widths the wrapper pads (30) or cuts into column blocks (160), both
    # modes and directions, on the val split's plans (H&M node counts, a
    # tenth of the edges, so the plain version's [E, D] messages stay small)
    a_err_odd = {}
    for bf16 in (False, True):
        vpg = sp.PallasGraph.from_graph(data.val_graph, width=cfg.hidden_layer_size,
                                        gather_bf16=bf16)
        for dd in ODD_WIDTHS:
            for dname, rows in (("to_user", NUM_ITEMS), ("to_item", NUM_USERS)):
                table = torch.randn((rows, dd), generator=gen_w, device=dev) * 0.1
                plan = getattr(vpg, dname)
                out = sp.pallas_segment_sum(plan, table, bf16)
                ref = sp.pallas_segment_sum_plain(plan, table, bf16)
                key = f"{'bf16' if bf16 else 'f32'}_D{dd}_{dname}"
                a_err_odd[key] = float((out - ref).abs().max())
                if out.shape != ref.shape or \
                        float(((out - ref).abs() - (atol + rtol * ref.abs())).max()) > 0:
                    fail(f"segsum {key}: beyond atol {atol} + rtol {rtol}")
                del table, out, ref
        del vpg
    log("segsum odd widths max abs err:", json.dumps(a_err_odd))
    d32 = cfg.hidden_layer_size
    shifted = params.item_emb.new_zeros(NUM_ITEMS * d32 + 1)[1:].view(NUM_ITEMS, d32)
    try:
        sp.pallas_segment_sum(prop.to_user, shifted)
        fail("segsum took a table that is not 16-byte aligned")
    except ValueError:
        pass
    warnings.filterwarnings("ignore", message="Sparse")
    csr = {
        dname: torch.sparse_csr_tensor(p.row_ptr, p.src.long(), p.w,
                                       size=(p.num_rows, tables[dname].shape[0]))
        for dname, p in (("to_user", modes["f32"].to_user), ("to_item", modes["f32"].to_item))
    }
    d = cfg.hidden_layer_size
    a_time = {}
    for mode, pg in modes.items():
        for dname in ("to_user", "to_item"):
            plan, table = getattr(pg, dname), tables[dname]
            a_time[f"{mode}_{dname}"] = time_ms(
                torch, lambda: sp.pallas_segment_sum(plan, table, pg.gather_bf16), 20)
        a_time[f"{mode}_step"] = time_ms(torch, lambda: sp.propagate_pallas(
            pg, params.user_emb, params.item_emb), 10)
        a_time[f"{mode}_step_device"], _ = device_ms(torch, lambda: sp.propagate_pallas(
            pg, params.user_emb, params.item_emb), 10, f"kernel A step {mode}")
        a_time[f"{mode}_plain_step"] = time_ms(torch, lambda: (
            sp.pallas_segment_sum_plain(pg.to_user, params.item_emb, pg.gather_bf16),
            sp.pallas_segment_sum_plain(pg.to_item, params.user_emb, pg.gather_bf16)), 3)
    for dname in ("to_user", "to_item"):
        a_time[f"library_{dname}"] = time_ms(
            torch, lambda: torch.sparse.mm(csr[dname], tables[dname]), 10)
    a_time["library_step"] = time_ms(torch, lambda: (
        torch.sparse.mm(csr["to_user"], params.item_emb),
        torch.sparse.mm(csr["to_item"], params.user_emb)), 5)
    for mode, pg in modes.items():   # the K=4 forward, device time after a warm-up
        a_time[f"{mode}_forward"] = time_ms(
            torch, lambda: lightgcn_forward(params, pg, cfg.num_iterations), 5)
    log("segsum ms:", json.dumps(a_time))

    # the function's inputs read once (CSR and source table), its output written once
    def a_bound(plan, src_rows):
        nbytes = sum(t.numel() * t.element_size() for t in (plan.row_ptr, plan.src, plan.w))
        nbytes += (src_rows + plan.num_rows) * d * 4
        return bound(nbytes, 2 * int(plan.src.shape[0]) * d, PEAK_F32_S)

    bounds = {"to_user": a_bound(prop.to_user, NUM_ITEMS), "to_item": a_bound(prop.to_item, NUM_USERS)}
    a_bnd = bounds["to_user"][0] + bounds["to_item"][0]
    windows = {f"{m}_{dn}": getattr(pg, dn).num_windows for m, pg in modes.items()
               for dn in ("to_user", "to_item")}
    log("segsum pieces and lanes:", json.dumps({
        f"{m}_{dn}": (int(getattr(pg, dn).piece_row.shape[0]), getattr(pg, dn).piece_lanes)
        for m, pg in modes.items() for dn in ("to_user", "to_item")}))
    log("segsum windows:", json.dumps(windows))
    kern["segsum"] = dict(
        name="segsum", route="cuda", source="laplace_gnn_recommendation_tpu_torch/csrc/segsum.cu",
        replaces="laplace_gnn_recommendation_tpu/ops/spmm_pallas.py:132 (_segsum_kernel)",
        max_abs_err=max(a_err.values()), tol=f"atol {TOL_SEGSUM[0]} + rtol {TOL_SEGSUM[1]}",
        max_abs_err_wide=a_err_wide, wide_d=WIDE_D,
        ms=a_time["bf16_step_device"], call_ms=a_time["bf16_step"],
        plain_ms=a_time["bf16_plain_step"], bound_ms=a_bnd,
        bound_by=bounds["to_item"][1], library_ms=None,
        per="one propagation step in the bf16-gather mode auto takes at H&M size: "
            "both directions, 2 launches",
        f32_ms=a_time["f32_step"], f32_plain_ms=a_time["f32_plain_step"],
        f32_library_ms=a_time["library_step"],
        direction_ms={k: v for k, v in a_time.items() if "step" not in k and "forward" not in k},
        forward_ms={m: a_time[f"{m}_forward"] for m in modes},
        direction_bound_ms={k: v[0] for k, v in bounds.items()},
        windows=windows,
        gathered_rows_bound_ms=2 * graph.num_edges * (d * 4 + 8) / PEAK_BYTES_S * 1e3,
    )
    log("segsum:", json.dumps(kern["segsum"]))
    record["segsum_options"] = segsum_options(torch, sp, graph, tables, dev, d)

    # B and C at the serving shape B=256, I=104,547 (detail rows)
    excl_users = np.arange(256)
    ex, exc = padded_user_items(excl_users, train_u.astype(np.int64), train_i)
    ex_t = torch.from_numpy(ex).to(dev)
    exc_t = torch.from_numpy(exc).to(dev)
    u256 = params.user_emb[:256].contiguous()
    items = params.item_emb
    mask256 = tp.exclusion_mask(NUM_ITEMS, ex_t, exc_t)
    q_items, scales = tp.row_quantize(items)
    q_items, scales = q_items.contiguous(), scales.contiguous()
    detail = []

    def topk_case(kind, users, item_t, k, mask):
        b = users.shape[0]
        if kind == "f32":
            i = item_t.shape[0]
            run = lambda: tp.streaming_mips_topk(users, item_t, k, mask)
            plain = lambda: tp.streaming_mips_topk_plain(users, item_t, k, mask)

            def lib():
                s = users @ item_t.T
                if mask is not None:
                    s = s.masked_fill(mask != 0, tp.NEG_INF)
                return torch.topk(s, k)
            vals, ids = run()
            pv, pi = plain()
            torch.cuda.synchronize()
            err = check_topk_ids(torch, f"topk_f32 B={b} I={i} k={k}", users, item_t,
                                 vals, ids, pv, mask, TOL_TOPK_F32)
            nbytes = (b + i) * users.shape[1] * 4 + (b * i if mask is not None else 0) + b * k * 8
            bnd = bound(nbytes, 2 * b * i * users.shape[1], PEAK_F32_S)
        else:
            qi, si = item_t
            i = qi.shape[0]
            run = lambda: tp.streaming_mips_topk_int8(users, qi, si, k, mask)
            plain = lambda: tp.streaming_mips_topk_int8_plain(users, qi, si, k, mask)
            i8 = -(-i // 8) * 8
            qi_pad = torch.cat([qi, qi.new_zeros((i8 - i, qi.shape[1]))]) if i8 != i else qi

            int_mm = pick_int_mm(torch, users.shape[0], qi_pad)

            def lib():
                qu, su = tp.row_quantize(users)
                raw = int_mm(qu, qi_pad)[:, :i]
                s = raw.float() * su.reshape(-1, 1) * si
                if mask is not None:
                    s = s.masked_fill(mask != 0, tp.NEG_INF)
                return torch.topk(s, k)
            if int_mm is None:
                lib = None
            vals, ids = run()
            pv, pi = plain()
            torch.cuda.synchronize()
            if not (torch.equal(vals, pv) and torch.equal(ids, pi)):
                fail(f"topk_int8 B={b} I={i} k={k}: not bitwise equal to the plain version")
            err = 0.0
            nbytes = b * users.shape[1] * 4 + i * (qi.shape[1] + 4) + \
                (b * i if mask is not None else 0) + b * k * 8
            bnd = bound(nbytes, 2 * b * i * users.shape[1], PEAK_INT8_S)
        dev_ms, host_ms = device_ms(torch, run, 10, f"{kind} B={b} I={i} k={k}")
        row = dict(kernel=kind, B=b, I=i, k=k, masked=mask is not None, max_abs_err=err,
                   call_ms=time_ms(torch, run, 10), device_ms=dev_ms, host_ms=host_ms,
                   plain_ms=time_ms(torch, plain, 3),
                   library_call_ms=None if lib is None else time_ms(torch, lib, 10),
                   library_device_ms=None if lib is None else device_ms(
                       torch, lib, 10, f"library {kind} B={b} I={i} k={k}")[0],
                   bound_ms=bnd[0], bound_by=bnd[1])
        log(f"topk: {json.dumps(row)}")
        detail.append(row)
        return row

    c_by_k = {}   # kernel C at B=256, I=104,547, masked, by k: the fold's share
    for m in (None, mask256):
        topk_case("f32", u256, items, 12, m)
        c_by_k[12] = topk_case("int8", u256, (q_items, scales), 12, m)
    for k_c in (1, 33):
        c_by_k[k_c] = topk_case("int8", u256, (q_items, scales), k_c, mask256)
    b_k256 = topk_case("f32", u256, items, 256, mask256)
    c_k256 = c_by_k[256] = topk_case("int8", u256, (q_items, scales), 256, mask256)
    # ties: scores on an exact grid (small integers times 1/4), the same f32
    # value in any summation order, so values and ids must equal the plain
    # version's exactly
    gen_t = torch.Generator(device=dev).manual_seed(3)
    tie_u = torch.randint(-1, 2, (256, d), generator=gen_t, device=dev).float()
    tie_i = torch.randint(-2, 3, (NUM_ITEMS, d), generator=gen_t, device=dev).float() * 0.25
    for k_tie in (12, 256):
        for m in (None, mask256):
            tv, ti = tp.streaming_mips_topk(tie_u, tie_i, k_tie, m)
            pv, pi = tp.streaming_mips_topk_plain(tie_u, tie_i, k_tie, m)
            if not (torch.equal(tv, pv) and torch.equal(ti, pi)):
                fail(f"topk_f32 on tied scores (k={k_tie}, masked={m is not None}): "
                     f"not equal to the plain version")
    log("topk_f32 tied scores: values and ids equal to the plain version")
    # widths the wrapper zero-pads (30) and rows too wide for two staged
    # tiles, which the kernel stages in column chunks (160; at k=256 too)
    b_err_odd = {}
    for dd in ODD_WIDTHS:
        uo = torch.randn((256, dd), generator=gen_t, device=dev) * 0.1
        io = torch.randn((NUM_ITEMS, dd), generator=gen_t, device=dev) * 0.1
        for k_o, m in ((12, None), (12, mask256), (256, mask256)):
            vo, ido = tp.streaming_mips_topk(uo, io, k_o, m)
            pvo, _ = tp.streaming_mips_topk_plain(uo, io, k_o, m)
            torch.cuda.synchronize()
            name = f"D={dd} k={k_o} masked={m is not None}"
            b_err_odd[name] = check_topk_ids(torch, f"topk_f32 {name}", uo, io, vo, ido, pvo, m,
                                             TOL_TOPK_F32)
        del uo, io
    log("topk_f32 odd widths max abs err:", json.dumps(b_err_odd))

    # kernel C where it can differ from its plain version; each case
    # bitwise equal to it
    def c_exact(name, users, qi, si, k, mask):
        pv, pi = tp.streaming_mips_topk_int8_plain(users, qi, si, k, mask)
        v, i = tp.streaming_mips_topk_int8(users, qi, si, k, mask)
        torch.cuda.synchronize()
        if not (torch.equal(v, pv) and torch.equal(i, pi)):
            fail(f"topk_int8 {name}: not bitwise equal to the plain version")
        return pv, pi

    half = NUM_ITEMS // 2   # exact ties: the catalog's second half repeats its first
    dup = items.clone()
    dup[half:2 * half] = items[:half]
    dq, ds = tp.row_quantize(dup)
    for k_tie in (12, 256):
        for m in (None, mask256):
            tv, _ = c_exact(f"ties k={k_tie} masked={m is not None}", u256, dq, ds, k_tie, m)
            if not bool((tv[:, 1:] == tv[:, :-1]).any()):
                fail("topk_int8 tie case holds no tied scores")
    three = (17, 40_000, NUM_ITEMS - 1)   # user 5 may take these three items alone
    m3 = mask256.clone()
    m3[5] = 1
    m3[5, list(three)] = 0
    tv, ti = c_exact("3 eligible items", u256, q_items, scales, 12, m3)
    if not (sorted(ti[5, :3].tolist()) == list(three) and bool((ti[5, 3:] == 0).all())
            and bool((tv[5, 3:] == tp.NEG_INF).all())):
        fail("topk_int8: the user with 3 eligible items is not (3 items, then NEG_INF / id 0)")
    for k_odd in (1, 33):
        for m in (None, mask256):
            c_exact(f"k={k_odd} masked={m is not None}", u256, q_items, scales, k_odd, m)
    for d_odd in (20, 7):   # word and byte staging; the mask rows are unaligned (I odd)
        qo, so = tp.row_quantize(torch.randn((NUM_ITEMS, d_odd), generator=gen_t, device=dev))
        uo = torch.randn((256, d_odd), generator=gen_t, device=dev)
        for m in (None, mask256):
            c_exact(f"D={d_odd} masked={m is not None}", uo, qo, so, 12, m)
    q_off = torch.zeros(NUM_ITEMS * d + 16, dtype=torch.int8, device=dev)[1:1 + NUM_ITEMS * d]
    q_off = q_off.view(NUM_ITEMS, d)
    q_off.copy_(q_items)
    s_off = torch.zeros(NUM_ITEMS + 4, device=dev)[1:1 + NUM_ITEMS].view(1, NUM_ITEMS)
    s_off.copy_(scales)
    c_exact("catalog and scales not 16-byte aligned", u256, q_off, s_off, 12, mask256)
    log("topk_int8 exact cases: values and ids equal to the plain version")

    # the shapes the main path gives B and C
    gen_big = torch.Generator(device=dev).manual_seed(1)
    big_items = torch.randn((BIG_I, d), generator=gen_big, device=dev) * 0.1
    big_users = torch.arange(BIG_B)
    bex, bexc = padded_user_items(big_users.numpy(), train_u.astype(np.int64), train_i)
    bex_t, bexc_t = torch.from_numpy(bex).to(dev), torch.from_numpy(bexc).to(dev)
    big_mask = tp.exclusion_mask(BIG_I, bex_t, bexc_t)
    b_main = topk_case("f32", params.user_emb[:BIG_B].contiguous(), big_items, 12, big_mask)
    serve_i = -(-NUM_ITEMS // 2048) * 2048
    pad_items = torch.cat([items, items.new_zeros((serve_i - NUM_ITEMS, d))])
    pq, ps = tp.row_quantize(pad_items)
    serve_mask = tp.exclusion_mask(serve_i, ex_t, exc_t)
    serve_mask[:, NUM_ITEMS:] = 1
    c_main = topk_case("int8", u256, (pq.contiguous(), ps.contiguous()), 12, serve_mask)
    record["topk_detail"] = detail

    # ---- 3. main path --------------------------------------------------------
    _build.launches.clear()
    t_main = time.perf_counter()
    t0 = time.perf_counter()
    uf, _, itf, _ = lightgcn_forward(params, prop, cfg.num_iterations)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    req = rng.choice(NUM_USERS, SERVE_USERS, replace=False)
    t0 = time.perf_counter()
    qserver = RetrievalServer(uf, itf, k=12, exclude_edges=(train_u, train_i),
                              batch_size=256, quantized=True, device=dev)
    t_qbuild = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_ids, q_scores = qserver.recommend(req)
    t_qserve = time.perf_counter() - t0
    fserver = RetrievalServer(uf, itf, k=12, exclude_edges=(train_u, train_i),
                              batch_size=256, quantized=False, device=dev)
    t0 = time.perf_counter()
    f_ids, f_scores = fserver.recommend(req)
    t_fserve = time.perf_counter() - t0
    big_v, big_ids = auto_mips_topk(uf[:BIG_B], big_items, 12, bex_t, bexc_t)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t_main
    launches = dict(_build.launches)
    record["main_path"] = dict(
        forward_s=t_fwd, quantized_server_build_s=t_qbuild, quantized_recommend_s=t_qserve,
        f32_recommend_s=t_fserve, total_s=t_main, launches=launches,
    )
    log("main path:", json.dumps(record["main_path"]))

    # ---- checks on what came out ------------------------------------------
    # the forward against the plain forward in the mode auto took: step by
    # step on the kernel's own inputs (only the f32 summation order differs),
    # then free-running (bf16 roundings of f32 values that differ in their
    # last bits may flip, so it gets one bf16 ulp of the largest input)
    def plain_step(pg, eu, ei):
        return (sp.pallas_segment_sum_plain(pg.to_user, ei, pg.gather_bf16),
                sp.pallas_segment_sum_plain(pg.to_item, eu, pg.gather_bf16))

    eu, ei = params.user_emb, params.item_emb
    step_err = 0.0
    for _ in range(cfg.num_iterations):
        ku, ki = sp.propagate_pallas(prop, eu, ei)
        for out, ref in zip((ku, ki), plain_step(prop, eu, ei)):
            step_err = max(step_err, float((out - ref).abs().max()))
            if float(((out - ref).abs() - (atol + rtol * ref.abs())).max()) > 0:
                fail(f"forward step through kernel A beyond atol {atol} + rtol {rtol}")
        eu, ei = ku, ki
    ref_uf, ref_itf = multiscale_loop(plain_step, prop, params.user_emb, params.item_emb,
                                      cfg.num_iterations)
    fwd_err = max(float((uf - ref_uf).abs().max()), float((itf - ref_itf).abs().max()))
    e0_max = max(float(params.user_emb.abs().max()), float(params.item_emb.abs().max()))
    fwd_tol = e0_max * 2.0 ** -8 if prop.gather_bf16 else 1e-5
    if not fwd_err <= fwd_tol:
        fail(f"forward through kernel A differs from the plain forward by {fwd_err} > {fwd_tol}")
    f32_uf, _, f32_itf, _ = lightgcn_forward(params, graph, cfg.num_iterations)
    bf16_vs_f32 = max(float((uf - f32_uf).abs().max()), float((itf - f32_itf).abs().max()))
    log(f"forward: {'bf16-gather' if prop.gather_bf16 else 'f32'} mode; step max abs err "
        f"{step_err}, free-running {fwd_err} (tol {fwd_tol}); against the f32 plain "
        f"forward {bf16_vs_f32} (information)")
    if not (torch.isfinite(uf).all() and torch.isfinite(itf).all()):
        fail("non-finite final embeddings")
    seen = qserver._ex[req]
    for name, ids, scores in (("int8", q_ids, q_scores), ("f32", f_ids, f_scores)):
        if ids.shape != (SERVE_USERS, 12) or not np.isfinite(scores).all():
            fail(f"{name} server: bad output shape or values")
        if (ids < 0).any() or (ids >= NUM_ITEMS).any():
            fail(f"{name} server returned an id outside the catalog (pad tail)")
        if (ids[:, :, None] == seen[:, None, :]).any():
            fail(f"{name} server returned an excluded (train) item")
    agree = float(np.mean([len(set(a) & set(b)) / 12 for a, b in zip(q_ids, f_ids)]))
    if agree < 0.85:
        fail(f"int8 vs f32 top-12 agreement {agree} < 0.85")
    big_ref_v, _ = tp.streaming_mips_topk_plain(uf[:BIG_B], big_items, 12, big_mask)
    big_err = float((big_v - big_ref_v).abs().max())
    if not big_err <= TOL_TOPK_F32:
        fail(f"auto_mips_topk streaming result off by {big_err}")
    for key in ("segsum", "topk_f32", "topk_int8"):
        if launches.get(key, 0) <= 0:
            fail(f"kernel {key} was not launched on the main path")
    if launches["topk_int8"] != -(-SERVE_USERS // 256):
        fail(f"kernel C launched {launches['topk_int8']} times for {SERVE_USERS} users")
    record["checks"] = dict(forward_mode="bf16" if prop.gather_bf16 else "f32",
                            forward_step_max_abs_err=step_err, forward_max_abs_err=fwd_err,
                            forward_vs_f32_plain=bf16_vs_f32, int8_f32_top12_agreement=agree,
                            auto_stream_max_abs_err=big_err)
    log("checks:", json.dumps(record["checks"]))

    # ---- trace: the main path once more under torch.profiler ----------------
    def main_path_again():
        out = lightgcn_forward(params, prop, cfg.num_iterations)
        qserver.recommend(req)
        fserver.recommend(req)
        auto_mips_topk(out[0][:BIG_B], big_items, 12, bex_t, bexc_t)

    record["trace"] = trace(torch, main_path_again)
    del qserver, fserver, main_path_again

    # ---- 5. training --------------------------------------------------------
    training = train_phase(torch, data, dev, record)
    del data, graph, prop, params

    # ---- 6. the dense tier; 7. the ranking stack; 8. PinSAGE ----------------
    dense_phase(torch, dev, record)
    ranking_phase(torch, dev, record)
    pinsage = pinsage_phase(torch, dev, record, hm_edges)
    del hm_edges

    def pinsage_launches(key):
        return pinsage["launches"].get(key, 0) + pinsage["artifacts_path"]["launches"].get(key, 0)

    kern["segsum"]["launches"] = launches["segsum"]
    kern["segsum"].update(
        train_step_launches=training["step"]["kernel_a_launches"],
        train_run_launches=training["train"]["kernel_a_launches"],
        train_run_steps=TRAIN_STEPS,
        train_step_ms=training["step"]["device_ms"],
        train_step_call_ms=training["step"]["call_ms"],
        train_grad_max_abs_err={k: v["max_abs_err"] for k, v in training["grad_check"].items()},
        train_grad_tol=f"{TOL_GRAD_F32} (f32) / {TOL_GRAD_BF16} (bf16) of the largest entry",
        max_abs_err_odd_widths=a_err_odd,
        pinsage_launches=pinsage_launches("segsum"),
    )

    def timed(row, prefix=""):
        """A timed row's numbers for the ``kernels`` line: ``ms`` and
        ``library_ms`` device time, ``call_ms`` and ``library_call_ms``
        call time."""
        out = dict(ms=row["device_ms"], call_ms=row["call_ms"], host_ms=row["host_ms"],
                   library_ms=row["library_device_ms"], library_call_ms=row["library_call_ms"])
        if not prefix:
            out.update(plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                       bound_by=row["bound_by"])
        return {prefix + key: v for key, v in out.items()}
    kern["topk_f32"] = dict(
        name="topk_f32", route="cuda",
        source="laplace_gnn_recommendation_tpu_torch/csrc/topk_f32.cu",
        replaces="laplace_gnn_recommendation_tpu/ops/topk_pallas.py:69 (_kernel), :93 (_kernel_masked)",
        launches=launches["topk_f32"], max_abs_err=b_main["max_abs_err"], **timed(b_main),
        max_abs_err_odd_widths=b_err_odd,
        per=f"B={BIG_B} I={BIG_I} k=12 masked",
        **timed(b_k256, "k256_"), k256_per="B=256 I=104547 k=256 masked",
        pinsage_launches=pinsage_launches("topk_f32"),
    )
    kern["topk_int8"] = dict(
        name="topk_int8", route="cuda", source="laplace_gnn_recommendation_tpu_torch/csrc/topk.cu",
        replaces="laplace_gnn_recommendation_tpu/ops/topk_pallas.py:179 (_kernel_int8), "
                 ":208 (_kernel_int8_masked)",
        launches=launches["topk_int8"], max_abs_err=c_main["max_abs_err"], **timed(c_main),
        per=f"B=256 I={serve_i} k=12 masked",
        **timed(c_k256, "k256_"), k256_per="B=256 I=104547 k=256 masked",
        by_k_ms={k_c: c_by_k[k_c]["device_ms"] for k_c in sorted(c_by_k)},
        pinsage_launches=pinsage_launches("topk_int8"),
    )
    record["kernels"] = list(kern.values())
    log(json.dumps({"kernels": record["kernels"]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
