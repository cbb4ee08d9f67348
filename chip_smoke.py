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
   without a mask. Each kernel's time, its plain version's time and one
   PyTorch library call's time (``library_ms``, measured here only) are
   taken with CUDA events.
3. Main path at full width: LightGCN defaults (D=32, K=4) over H&M
   cardinalities (1,371,980 users × 104,547 items, ~25M train edges) —
   ``select_propagation`` → ``lightgcn_forward`` through kernel A, a quantized
   and an f32 ``RetrievalServer`` answering 1,000 users with train-item
   exclusions (kernel C), and one ``auto_mips_topk`` call that streams
   through kernel B. Launch counters are zeroed before and read after. The
   forward is held against the plain forward in the same mode.
4. The main path once more under ``torch.profiler``: kernel time by name
   and the card's idle share of the host wall time.
5. Prints a ``{"kernels": [...]}`` JSON line, the card's line, and as the
   last line ``{"ok": true, "device": {...}}``.

Any failure exits nonzero; the script needs a CUDA card and the checkout.
"""
import dataclasses
import json
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
WINDOW_SHARES = (0, 0.25, 0.5, 0.75)   # kernel A's window sizes tried, as shares of L2

# H100 SXM published peaks (NVIDIA data sheet; dense, at a 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_INT8_S = 1979e12

TOL_SEGSUM = (1e-5, 1e-5)   # (atol, rtol): f32 sums in another order
TOL_TOPK_F32 = 1e-6         # abs, on scores ~1e-2: f32 dot in another order
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
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:12])
    out = dict(wall_ms=wall_ms, device_busy_ms=busy, device_idle_share=1.0 - busy / wall_ms,
               top=top)
    log("trace:", json.dumps(out))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from laplace_gnn_recommendation_tpu_torch import _build
    from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
    from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
    from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import padded_user_items
    from laplace_gnn_recommendation_tpu_torch.data.splitting import random_edge_split
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
    tr, _, _ = random_edge_split(len(eu), seed=1)
    train_u, train_i = eu[tr], ei[tr]
    t_edges = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = BipartiteGraph.from_edges(train_u, train_i, NUM_USERS, NUM_ITEMS, device=dev)
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
        ms=a_time["bf16_step"], plain_ms=a_time["bf16_plain_step"], bound_ms=a_bnd,
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
        row = dict(kernel=kind, B=b, I=i, k=k, masked=mask is not None, max_abs_err=err,
                   ms=time_ms(torch, run, 10), plain_ms=time_ms(torch, plain, 3),
                   library_ms=None if lib is None else time_ms(torch, lib, 10),
                   bound_ms=bnd[0], bound_by=bnd[1])
        log(f"topk: {json.dumps(row)}")
        detail.append(row)
        return row

    for m in (None, mask256):
        topk_case("f32", u256, items, 12, m)
        topk_case("int8", u256, (q_items, scales), 12, m)
    b_k256 = topk_case("f32", u256, items, 256, mask256)
    topk_case("int8", u256, (q_items, scales), 256, mask256)
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

    kern["segsum"]["launches"] = launches["segsum"]
    kern["topk_f32"] = dict(
        name="topk_f32", route="cuda",
        source="laplace_gnn_recommendation_tpu_torch/csrc/topk_f32.cu",
        replaces="laplace_gnn_recommendation_tpu/ops/topk_pallas.py:69 (_kernel), :93 (_kernel_masked)",
        launches=launches["topk_f32"], max_abs_err=b_main["max_abs_err"], ms=b_main["ms"],
        plain_ms=b_main["plain_ms"], bound_ms=b_main["bound_ms"], bound_by=b_main["bound_by"],
        library_ms=b_main["library_ms"], per=f"B={BIG_B} I={BIG_I} k=12 masked",
        k256_ms=b_k256["ms"], k256_library_ms=b_k256["library_ms"],
        k256_per="B=256 I=104547 k=256 masked",
    )
    kern["topk_int8"] = dict(
        name="topk_int8", route="cuda", source="laplace_gnn_recommendation_tpu_torch/csrc/topk.cu",
        replaces="laplace_gnn_recommendation_tpu/ops/topk_pallas.py:179 (_kernel_int8), "
                 ":208 (_kernel_int8_masked)",
        launches=launches["topk_int8"], max_abs_err=c_main["max_abs_err"], ms=c_main["ms"],
        plain_ms=c_main["plain_ms"], bound_ms=c_main["bound_ms"], bound_by=c_main["bound_by"],
        library_ms=c_main["library_ms"], per=f"B=256 I={serve_i} k=12 masked",
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
