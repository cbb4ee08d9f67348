"""The port's tracer (``utils/profiling.tracer``) and the spans and counters
the program records on it: the off path records and builds nothing, spans
nest per thread, and the retrieval server, the ranking sampler and
LightGCN's train step mark their phases without changing a result.

The one ``requires_cuda`` test runs on a card (it skips here):
``python -m pytest --noconftest tests/test_torch_tracing.py -m requires_cuda``.
"""
import threading
import time

import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu_torch.configs import Config, LightGCNConfig
from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph, HostCSR
from laplace_gnn_recommendation_tpu_torch.data.prefetch import prefetch
from laplace_gnn_recommendation_tpu_torch.data.sampler import SubgraphSampler
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
from laplace_gnn_recommendation_tpu_torch.models.lightgcn import init_lightgcn
from laplace_gnn_recommendation_tpu_torch.serving import RetrievalServer
from laplace_gnn_recommendation_tpu_torch.train import lightgcn_pipeline
from laplace_gnn_recommendation_tpu_torch.utils.profiling import NULL_SPAN, tracer

U, I = 60, 40


@pytest.fixture
def traced():
    """The process's tracer, enabled for one test and left off after it."""
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.drain()


@pytest.fixture
def no_events(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event was built")

    monkeypatch.setattr(torch.cuda, "Event", refuse)


@pytest.fixture(scope="module")
def edges():
    return random_bipartite_edges(seed=3, num_users=U, num_items=I, avg_degree=6)


def _server(edges):
    rng = np.random.default_rng(0)
    return RetrievalServer(rng.normal(size=(U, 8)).astype(np.float32),
                           rng.normal(size=(I, 8)).astype(np.float32), k=5,
                           exclude_edges=edges, batch_size=8, device="cpu")


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.start)


# ---- the tracer itself -------------------------------------------------------

def test_off_path_records_nothing(no_events, edges):
    assert not tracer.on
    assert tracer.span("a") is NULL_SPAN and tracer.span("b", device=True) is NULL_SPAN
    with tracer.span("a", device=True):
        tracer.count("c", 3)
    _server(edges).recommend(np.arange(20))
    assert tracer.drain() == ([], {})


def test_spans_nest_per_thread(traced):
    def worker():
        with tracer.span("w.outer"):
            with tracer.span("w.inner"):
                pass

    with tracer.span("outer"):
        with tracer.span("mid"):
            with tracer.span("inner"):
                tracer.count("n", 2)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with tracer.span("second"):
            tracer.count("n")
    with tracer.span("next"):
        pass
    spans, counters = tracer.drain()
    by = {s.name: s for s in spans}
    main, other = threading.get_native_id(), by["w.outer"].thread
    assert counters == {"n": 3}
    assert other != main
    assert all(by[n].thread == main for n in ("outer", "mid", "inner", "second", "next"))
    assert by["outer"].parent is None and by["outer"].root == by["outer"].id
    assert by["mid"].parent == by["outer"].id and by["second"].parent == by["outer"].id
    assert by["inner"].parent == by["mid"].id
    assert {by[n].root for n in ("mid", "inner", "second")} == {by["outer"].id}
    assert by["next"].parent is None and by["next"].root == by["next"].id
    # a worker's spans nest on their own thread, outside the main thread's
    assert by["w.outer"].parent is None and by["w.outer"].root == by["w.outer"].id
    assert by["w.inner"].parent == by["w.outer"].id
    for s in spans:
        assert s.start <= s.end
    assert by["outer"].start <= by["mid"].start <= by["inner"].start
    assert by["inner"].end <= by["mid"].end <= by["outer"].end
    assert tracer.drain() == ([], {})


@pytest.mark.parametrize("reenable", [False, True])
def test_span_open_at_disable_is_dropped(traced, reenable):
    """enable → run → disable → drain while a worker's span is still open:
    the drain holds what ended, and the worker's span, ending later (after a
    fresh ``enable`` too), is dropped rather than kept for a later drain."""
    opened, release = threading.Event(), threading.Event()

    def worker():
        with tracer.span("sampler.batch"):
            opened.set()
            release.wait(timeout=30)

    t = threading.Thread(target=worker)
    t.start()
    assert opened.wait(timeout=30)
    with tracer.span("step"):
        pass
    tracer.disable()
    spans, _ = tracer.drain()
    assert [s.name for s in spans] == ["step"]
    if reenable:
        tracer.enable()
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    with tracer.span("after"):
        pass
    spans, _ = tracer.drain()
    assert [s.name for s in spans] == (["after"] if reenable else [])


# ---- where the program records -----------------------------------------------

def test_retrieval_batches_traced(edges):
    """One request of 21 users in batches of 8: a ``retrieve.request`` root
    holding the one upload, three batches of one ``retrieve.score`` each,
    and the one readback; the counters come from the host counts, and the
    request's one wait is counted."""
    srv = _server(edges)
    users = np.random.default_rng(1).integers(0, U, 21)
    ids_off, scores_off = srv.recommend(users)
    tracer.enable()
    try:
        ids_on, scores_on = srv.recommend(users)
    finally:
        tracer.disable()
    spans, counters = tracer.drain()
    np.testing.assert_array_equal(ids_on, ids_off)
    np.testing.assert_array_equal(scores_on, scores_off)

    (req,) = [s for s in spans if s.name == "retrieve.request"]
    assert req.parent is None and req.root == req.id
    assert len(spans) == 1 + 1 + 3 * 2 + 1
    kids = _children(spans, req)
    assert [s.name for s in kids] == (["retrieve.upload"] + ["retrieve.batch"] * 3
                                      + ["retrieve.readback"])
    assert all(s.root == req.id and s.thread == req.thread for s in spans)
    assert all(a.end <= c.start for a, c in zip(kids, kids[1:]))
    assert req.start <= kids[0].start and kids[-1].end <= req.end
    assert not any(s.device for s in spans)
    for b in kids[1:-1]:
        (score,) = _children(spans, b)
        assert score.name == "retrieve.score" and b.start <= score.start <= score.end <= b.end
    chunk = np.pad(users, (0, 3 * 8 - len(users)))
    exc = srv._exc.numpy()
    slots, excluded = chunk.size * srv._ex.shape[1], int(exc[chunk].sum())
    assert counters == {"retrieve.exclusion_slots": slots, "retrieve.excluded_ids": excluded,
                        "retrieve.host_waits": 1}
    assert 0 < excluded <= slots


def test_prefetched_sampler_batches_on_the_worker(traced, edges):
    eu, ei = edges
    s = SubgraphSampler(Config(batch_size=8, num_neighbors=8, n_hop_neighbors=2, k=4),
                        HostCSR.from_edges(eu, ei, U, I), HostCSR.from_edges(ei, eu, I, U),
                        train=True, seed=0)
    batches = list(prefetch(s.epoch_batches(shuffle=True), buffer_size=1))
    spans, _ = tracer.drain()
    assert batches and [x.name for x in spans] == ["sampler.batch"] * len(batches)
    assert {x.thread for x in spans} != {threading.get_native_id()}
    assert len({x.thread for x in spans}) == 1
    assert all(x.parent is None for x in spans)


def test_lightgcn_step_traced(edges):
    eu, ei = edges
    g = BipartiteGraph.from_edges(eu, ei, U, I, pad_multiple=64, device="cpu")
    cfg = LightGCNConfig(hidden_layer_size=8, num_iterations=2, batch_size=32,
                         propagation="pallas")
    prop = lightgcn_pipeline.select_propagation(cfg, g)
    step, tx = lightgcn_pipeline.make_train_step(cfg, g, int(g.user_deg.max()),
                                                 prop_graph=prop, device="cpu")

    def run(steps):
        p = init_lightgcn(U, I, 8, generator=torch.Generator().manual_seed(1), device="cpu")
        opt, gen = tx.init(p), torch.Generator().manual_seed(2)
        for _ in range(steps):
            p, opt, loss = step(p, opt, gen)
        return p, loss

    off, loss_off = run(3)
    tracer.enable()
    try:
        on, loss_on = run(3)
    finally:
        tracer.disable()
    spans, _ = tracer.drain()
    assert torch.equal(on.user_emb, off.user_emb) and torch.equal(on.item_emb, off.item_emb)
    assert torch.equal(loss_on, loss_off)
    names = [s.name for s in sorted(spans, key=lambda s: s.start)]
    assert names.count("propagate") == 2 * 3
    assert [n for n in names if n != "propagate"] == ["bpr.sample", "bpr.grad", "adam"] * 3
    grads = [s for s in spans if s.name == "bpr.grad"]
    for s in spans:
        if s.name == "propagate":
            # the forward and (on the CPU, on the caller's thread) the backward
            assert s.device and s.parent in {x.id for x in grads}


# ---- on the card -----------------------------------------------------------------

@pytest.mark.requires_cuda
def test_device_spans_on_the_card():
    """Device spans lie between the anchor and ``drain``, in order, and hold
    the kernels launched inside them as ``torch.profiler`` times them. The
    profiler's clock is tied to the spans' at the ``sleep`` span's start: its
    entry event and its one kernel run back to back on the card, queued
    behind the matrix products, so no host latency enters. The two clocks
    may run at slightly different rates, so the room grows by 5% of the
    distance from that point."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracer.enable()
        try:
            anchor_host = tracer._anchor[0]
            with tracer.span("mm", device=True):
                for _ in range(8):
                    x = (x @ x).clamp_(-1, 1)
            with tracer.span("sleep", device=True):
                torch.cuda._sleep(20_000_000)
            spans, _ = tracer.drain()
            drained = time.perf_counter_ns()
        finally:
            tracer.disable()
    by = {s.name: s for s in spans}
    mm, sleep = by["mm"], by["sleep"]
    assert anchor_host <= mm.device_start < mm.device_end <= sleep.device_start
    assert sleep.device_start < sleep.device_end <= drained
    assert mm.start <= mm.device_end and sleep.start <= sleep.device_end

    kernels = [(e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
               for e in prof.profiler.kineto_results.events() if e.device_type().name == "CUDA"]
    sleeps = [k for k in kernels if "spin" in k[0].lower() or "sleep" in k[0].lower()]
    assert len(sleeps) == 1
    _, a_s, b_s = sleeps[0]
    off = a_s - sleep.device_start

    def room(t):   # ns
        return 50_000 + 0.05 * abs(t - a_s)

    assert abs((b_s - off) - sleep.device_end) <= room(b_s), (b_s - a_s, sleep.device_end -
                                                               sleep.device_start)
    others = [(a, b) for n, a, b in kernels if (n, a, b) not in sleeps]
    assert len(others) >= 16
    for a, b in others:
        assert mm.device_start - room(a) <= a - off <= b - off <= mm.device_end + room(b), \
            (a - off - mm.device_start, mm.device_end - (b - off))
