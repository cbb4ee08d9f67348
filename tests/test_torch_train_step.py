"""The training step of the PyTorch port against the JAX package.

* ``bpr_loss`` (``canonical`` and ``legacy``): values and gradients against
  JAX's, on the same rows.
* Gradients through the kernel tier: ``propagate_pallas`` and the
  self-adjoint loop against ``jax.grad`` through the JAX
  ``lightgcn_propagate_pallas`` (Pallas in interpret mode) in the f32 mode,
  and through ``lightgcn_propagate_blocked`` with ``gather_bf16`` in the
  bf16-gather mode. On the card the kernel's output has no ``grad_fn``: a
  test runs the tier with a segment sum whose output is detached, as the
  kernel's is, and still gets the gradient — which it would not if the
  gradient came from autograd of the plain version.
* One fixed batch, three steps against ``jax.value_and_grad`` +
  ``optax.adam`` under the staircase decay, across a decay boundary: loss,
  gradients, params and Adam moments after each step.
* ``eval_loss`` against JAX's on the negatives JAX's key draws.
* A checkpoint the JAX ``save_state`` wrote resumes in the port.

Tolerances: f32 sums in another order give ~1e-7 relative per sum; after
K hops and their backward, values of order 1 agree to rtol 1e-5, atol
1e-6, and gradients of the BPR loss (order 1e-3 here) to atol 1e-8. The
bf16-gather mode forms the same bf16 messages in both packages (a flip of a
bf16 rounding between hops would need an f32 difference at a rounding tie;
none occurs on these inputs), so it gets the same tolerances. Adam divides
by sqrt(nu) + eps, so parameters get rtol 1e-5, atol 1e-6 (updates of
order lr = 1e-2 on entries of order 0.1), and the moments rtol 1e-5 of
their largest entry.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_gnn_recommendation_tpu.configs import LightGCNConfig as JConfig
from laplace_gnn_recommendation_tpu.data.graph import BipartiteGraph as JGraph
from laplace_gnn_recommendation_tpu.data.lightgcn_data import create_lightgcn_data as j_create
from laplace_gnn_recommendation_tpu.models.lightgcn import LightGCNParams as JParams
from laplace_gnn_recommendation_tpu.models.lightgcn import bpr_loss as j_bpr
from laplace_gnn_recommendation_tpu.models.lightgcn import lightgcn_forward as j_forward
from laplace_gnn_recommendation_tpu.ops import spmm_blocked as jsb
from laplace_gnn_recommendation_tpu.ops import spmm_pallas as jsp
from laplace_gnn_recommendation_tpu.train import checkpoint as jckpt
from laplace_gnn_recommendation_tpu.train import lightgcn_pipeline as jpipe
from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import create_lightgcn_data
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
from laplace_gnn_recommendation_tpu_torch.models.lightgcn import (
    LightGCNParams,
    bpr_loss,
    lightgcn_adam_state_from_jax,
    lightgcn_forward,
    lightgcn_params_from_jax,
)
from laplace_gnn_recommendation_tpu_torch.ops import sampling
from laplace_gnn_recommendation_tpu_torch.ops import spmm_pallas as tsp
from laplace_gnn_recommendation_tpu_torch.ops.multiscale import self_adjoint_multiscale
from laplace_gnn_recommendation_tpu_torch.ops.spmm import lightgcn_propagate
from laplace_gnn_recommendation_tpu_torch.train import checkpoint as tckpt
from laplace_gnn_recommendation_tpu_torch.train import lightgcn_pipeline as tpipe

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-8


def _graph_pair(seed, U, I, E):
    rng = np.random.default_rng(seed)
    eu, ei = rng.integers(0, U, E), rng.integers(0, I, E)
    return JGraph.from_edges(eu, ei, U, I), BipartiteGraph.from_edges(eu, ei, U, I, device="cpu")


def _tables(seed, U, I, D, std=0.1):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(U, D)) * std).astype(np.float32),
            (rng.normal(size=(I, D)) * std).astype(np.float32))


def _strict_segment_sum(calls):
    """The kernel's contract on the CPU: it takes only materialized,
    contiguous f32 tables and returns a result with no ``grad_fn``."""
    def segment_sum(plan, table, gather_bf16=False):
        assert table is not None and table.dtype == torch.float32
        assert table.is_contiguous() and table.data_ptr() % 16 == 0
        calls.append(plan.num_rows)
        return tsp.pallas_segment_sum_plain(plan, table, gather_bf16).detach()
    return segment_sum


@pytest.mark.parametrize("variant", ["canonical", "legacy"])
def test_bpr_loss_matches_jax(variant):
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(64, 8)).astype(np.float32) for _ in range(6)]
    ref, ref_g = jax.value_and_grad(
        lambda *a: j_bpr(*a, 1e-3, variant), argnums=tuple(range(6)))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    loss = bpr_loss(*ts, 1e-3, variant)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=RTOL)
    for t, g in zip(ts, ref_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL, atol=GRAD_ATOL)
    rank_only = float(bpr_loss(*[t.detach() for t in ts], 0.0, variant))
    assert (rank_only < 0) == (variant == "legacy")   # the reference's sign quirk


def _ports(jg, tg, mode):
    if mode == "f32":
        return jsp.PallasGraph.from_graph(jg), tsp.PallasGraph.from_graph(tg)
    jbg = dataclasses.replace(jsb.BlockedGraph.from_graph(jg), gather_bf16=True)
    return jbg, tsp.PallasGraph.from_graph(tg, gather_bf16=True)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_loop_gradients_match_jax(mode):
    """Random cotangents through the whole K-loop: the JAX custom VJP and
    the port's Function give the same gradients."""
    U, I, D, K = 50, 35, 8, 3
    jg, tg = _graph_pair(3, U, I, 500)
    ue, ie = _tables(4, U, I, D)
    cu, ci = _tables(5, U, I, D, std=1.0)
    jop, top = _ports(jg, tg, mode)

    def jloss(u0, i0):
        uf, _, itf, _ = j_forward(JParams(u0, i0), jop, K)
        return jnp.sum(uf * cu) + jnp.sum(itf * ci)

    gu, gi = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ue), jnp.asarray(ie))
    u0 = torch.from_numpy(ue).requires_grad_()
    i0 = torch.from_numpy(ie).requires_grad_()
    uf, _, itf, _ = lightgcn_forward(LightGCNParams(u0, i0), top, K)
    assert type(uf.grad_fn).__name__ == "_SelfAdjointLoopBackward"
    ((uf * torch.from_numpy(cu)).sum() + (itf * torch.from_numpy(ci)).sum()).backward()
    np.testing.assert_allclose(u0.grad.numpy(), np.asarray(gu), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(i0.grad.numpy(), np.asarray(gi), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_propagate_pallas_gradients_match_jax(mode):
    U, I, D = 40, 30, 8
    jg, tg = _graph_pair(6, U, I, 300)
    ue, ie = _tables(7, U, I, D)
    cu, ci = _tables(8, U, I, D, std=1.0)
    jop, top = _ports(jg, tg, mode)
    jprop = jsp.propagate_pallas if mode == "f32" else jsb.propagate_blocked
    gu, gi = jax.grad(lambda u, i: sum(jnp.sum(a * c) for a, c in zip(jprop(jop, u, i), (cu, ci))),
                      argnums=(0, 1))(jnp.asarray(ue), jnp.asarray(ie))
    u = torch.from_numpy(ue).requires_grad_()
    i = torch.from_numpy(ie).requires_grad_()
    nu, ni = tsp.propagate_pallas(top, u, i)
    assert type(nu.grad_fn).__name__ == "_PropagatePallasBackward"
    ((nu * torch.from_numpy(cu)).sum() + (ni * torch.from_numpy(ci)).sum()).backward()
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(gu), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(i.grad.numpy(), np.asarray(gi), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gather_bf16", [False, True])
def test_rank_gradient_reaches_e0_through_the_functions(monkeypatch, gather_bf16):
    """The card's kernel returns a tensor with no ``grad_fn``. With such a
    segment sum the BPR gradient still reaches E⁰ rows that only the
    diffusion touches, equals the gradient of the plain-version run, and
    takes 2·K launches forward and 2·K backward — so it flows through the
    Functions, not through autograd of the plain version."""
    U, I, D, K = 60, 40, 8, 2
    _, tg = _graph_pair(9, U, I, 600)
    ue, ie = _tables(10, U, I, D)
    pg = tsp.PallasGraph.from_graph(tg, gather_bf16=gather_bf16)
    u, pos, neg = torch.arange(4), torch.tensor([0, 1, 2, 3]), torch.tensor([4, 5, 6, 7])

    def grads():
        e0 = LightGCNParams(torch.from_numpy(ue).requires_grad_(),
                            torch.from_numpy(ie).requires_grad_())
        uf, u0, itf, it0 = lightgcn_forward(e0, pg, K)
        loss = bpr_loss(uf[u], u0[u], itf[pos], it0[pos], itf[neg], it0[neg], 1e-6)
        return torch.autograd.grad(loss, (e0.user_emb, e0.item_emb))

    ref_u, ref_i = grads()
    calls = []
    monkeypatch.setattr(tsp, "pallas_segment_sum", _strict_segment_sum(calls))
    g_u, g_i = grads()
    assert len(calls) == 4 * K
    torch.testing.assert_close(g_u, ref_u, rtol=0, atol=0)
    torch.testing.assert_close(g_i, ref_i, rtol=0, atol=0)
    # rows outside the batch get a gradient only through the diffusion
    assert bool((g_u[4:].abs().sum(1) > 0).any()) and bool((g_i[8:].abs().sum(1) > 0).any())


def test_backward_takes_any_cotangent_layout(monkeypatch):
    """Autograd hands the backward an expanded cotangent for ``sum()``, a
    strided one for a slice, and zeros for an unused output; the kernel
    gets materialized, contiguous f32 tables every time."""
    _, tg = _graph_pair(11, 20, 15, 120)
    pg = tsp.PallasGraph.from_graph(tg)
    ue, ie = _tables(12, 20, 15, 8)
    calls = []
    monkeypatch.setattr(tsp, "pallas_segment_sum", _strict_segment_sum(calls))
    for used in (0, 1):
        u = torch.from_numpy(ue).requires_grad_()
        i = torch.from_numpy(ie).requires_grad_()
        tsp.propagate_pallas(pg, u, i)[used].sum().backward()
        read, unread = (i, u) if used == 0 else (u, i)   # new_user reads the item table
        assert bool((read.grad != 0).any()) and bool((unread.grad == 0).all())
    u = torch.from_numpy(ue).requires_grad_()
    uf, _ = self_adjoint_multiscale(tsp.propagate_pallas, pg, u, torch.from_numpy(ie), 2)
    uf[:, :3].sum().backward()
    # columns never mix: the gradient lives in the three summed columns
    assert bool((u.grad[:, :3] != 0).any()) and bool((u.grad[:, 3:] == 0).all())
    assert len(calls) == 2 * 4 + 4 * 2


def _small_data():
    return random_bipartite_edges(seed=11, num_users=120, num_items=80, avg_degree=12)


def _jax_adam_steps(cfg, jop, ue, ie, batch, n):
    sched = optax.exponential_decay(cfg.learning_rate, cfg.lr_decay_every, 0.95, staircase=True)
    tx = optax.adam(sched)
    p = JParams(jnp.asarray(ue), jnp.asarray(ie))
    s = tx.init(p)
    u, pos, neg = (jnp.asarray(x) for x in batch)

    def loss_fn(p):
        uf, u0, itf, it0 = j_forward(p, jop, cfg.num_iterations)
        return j_bpr(uf[u], u0[u], itf[pos], it0[pos], itf[neg], it0[neg],
                     cfg.Lambda, cfg.bpr_variant)

    out = []
    for _ in range(n):
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, s = tx.update(g, s)
        p = optax.apply_updates(p, upd)
        out.append((float(loss), g, p, s))
    return out, tx


def _fixed_batch(seed, U, I, B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, U, B).astype(np.int32), rng.integers(0, I, B).astype(np.int32),
            rng.integers(0, I, B).astype(np.int32))


def _port_step(monkeypatch, cfg, tg, batch, seen_grads):
    """The port's step on a fixed batch: the sampler returns ``batch``, and
    the gradients the update receives are recorded."""
    monkeypatch.setattr(tpipe, "sample_bpr_batch",
                        lambda *a, **k: tuple(torch.from_numpy(x) for x in batch))
    step, tx = tpipe.make_train_step(cfg, tg, int(tg.user_deg.max()),
                                     prop_graph=tsp.PallasGraph.from_graph(tg), device="cpu")
    update = tx.update_

    def recording_update(grads, state, params):
        seen_grads.append((grads.user_emb.clone(), grads.item_emb.clone()))
        return update(grads, state, params)

    tx.update_ = recording_update
    return step, tx


def _assert_state(params, state, grads, ref):
    loss_ref, g, p, s = ref
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(g.user_emb), rtol=RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(g.item_emb), rtol=RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(params.user_emb.numpy(), np.asarray(p.user_emb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(params.item_emb.numpy(), np.asarray(p.item_emb), rtol=RTOL, atol=ATOL)
    adam, sched = state
    jadam, jsched = s
    assert adam.count == int(jadam.count) == sched.count == int(jsched.count)
    for mine, theirs in ((adam.mu, jadam.mu), (adam.nu, jadam.nu)):
        for name in ("user_emb", "item_emb"):
            ref_m = np.asarray(getattr(theirs, name))
            np.testing.assert_allclose(getattr(mine, name).numpy(), ref_m, rtol=RTOL,
                                       atol=RTOL * np.abs(ref_m).max())


def test_three_steps_match_optax_across_a_decay_boundary(monkeypatch):
    U, I, D, K, B = 70, 50, 8, 2, 64
    jg, tg = _graph_pair(13, U, I, 700)
    ue, ie = _tables(14, U, I, D)
    batch = _fixed_batch(15, U, I, B)
    cfg = LightGCNConfig(hidden_layer_size=D, num_iterations=K, batch_size=B,
                         learning_rate=1e-2, lr_decay_every=2, Lambda=1e-4, propagation="pallas")
    refs, _ = _jax_adam_steps(cfg, jsp.PallasGraph.from_graph(jg), ue, ie, batch, 3)
    grads = []
    step, tx = _port_step(monkeypatch, cfg, tg, batch, grads)
    params = lightgcn_params_from_jax(ue, ie, device="cpu")
    state = tx.init(params)
    for n, ref in enumerate(refs):
        params, state, loss = step(params, state, torch.Generator())
        np.testing.assert_allclose(float(loss), ref[0], rtol=RTOL)
        _assert_state(params, state, grads[n], ref)
    # update 2 (from 0) is the first past the boundary: lr·0.95
    from laplace_gnn_recommendation_tpu_torch.train.adam import staircase_lr
    assert [staircase_lr(1e-2, 2, n) for n in range(3)] == pytest.approx([1e-2, 1e-2, 9.5e-3])


def test_eval_loss_matches_jax_on_its_negatives(monkeypatch):
    eu, ei = _small_data()
    jdata = j_create(eu, ei, 120, 80, pad_multiple=64)
    tdata = create_lightgcn_data(eu, ei, 120, 80, pad_multiple=64, device="cpu")
    ue, ie = _tables(16, 120, 80, 8)
    for variant in ("canonical", "legacy"):
        jcfg = JConfig(hidden_layer_size=8, num_iterations=2, Lambda=1e-3, bpr_variant=variant)
        cfg = LightGCNConfig(hidden_layer_size=8, num_iterations=2, Lambda=1e-3,
                             bpr_variant=variant)
        key = jax.random.PRNGKey(3)
        max_deg = int(np.asarray(jdata.val_graph.user_deg).max())
        ref = float(jpipe.eval_loss(jcfg, JParams(jnp.asarray(ue), jnp.asarray(ie)),
                                    jdata.val_graph, jdata.val_set, key, max_deg))
        e = len(jdata.val_set.edge_user)
        e_pad = -(-e // 4096) * 4096   # the JAX function draws for its padded edge array
        cands = np.array(jax.random.randint(key, (e_pad, 8), 0, 80, dtype=jnp.int32))[:e]
        monkeypatch.setattr(sampling, "draw_negative_candidates",
                            lambda gen, n, num_items, t=8: torch.from_numpy(cands[:n]))
        out = tpipe.eval_loss(cfg, lightgcn_params_from_jax(ue, ie, device="cpu"),
                              tdata.val_graph, tdata.val_set, torch.Generator(), max_deg)
        np.testing.assert_allclose(float(out), ref, rtol=RTOL)


def test_jax_checkpoint_resumes_in_the_port(monkeypatch, tmp_path):
    """params + Adam state written by the JAX ``save_state`` load into the
    port, and the next step from there matches JAX's next step."""
    U, I, D, K, B = 60, 45, 8, 2, 48
    jg, tg = _graph_pair(17, U, I, 600)
    ue, ie = _tables(18, U, I, D)
    batch = _fixed_batch(19, U, I, B)
    cfg = LightGCNConfig(hidden_layer_size=D, num_iterations=K, batch_size=B,
                         learning_rate=1e-2, lr_decay_every=1, Lambda=1e-4, propagation="pallas")
    refs, _ = _jax_adam_steps(cfg, jsp.PallasGraph.from_graph(jg), ue, ie, batch, 3)
    _, _, p2, s2 = refs[1]
    jckpt.save_state(os.path.join(tmp_path, "model_1"), {"params": p2, "opt_state": s2})
    jckpt.save_state(os.path.join(tmp_path, "model_0"), {"params": refs[0][2],
                                                         "opt_state": refs[0][3]})
    grads = []
    step, tx = _port_step(monkeypatch, cfg, tg, batch, grads)
    template_p = lightgcn_params_from_jax(np.zeros_like(ue), np.zeros_like(ie), device="cpu")
    state, ver = tckpt.load_latest(str(tmp_path), {"params": template_p,
                                                   "opt_state": tx.init(template_p)})
    assert ver == 1
    params, opt_state = state["params"], state["opt_state"]
    # the same state through the in-memory carry-over
    carried = lightgcn_adam_state_from_jax(s2[0].mu, s2[0].nu, int(s2[0].count), device="cpu")
    for a, b in zip(tckpt.tree_leaves_with_path(carried), tckpt.tree_leaves_with_path(opt_state)):
        assert a[0] == b[0]
        assert (torch.equal(a[1], b[1]) if isinstance(a[1], torch.Tensor) else a[1] == b[1])
    params, opt_state, loss = step(params, opt_state, torch.Generator())
    np.testing.assert_allclose(float(loss), refs[2][0], rtol=RTOL)
    _assert_state(params, opt_state, grads[0], refs[2])


def test_port_checkpoint_keys_are_jax_keys(tmp_path):
    """The port writes the JAX package's key names, so each side's
    checkpoints name the same leaves."""
    p = JParams(jnp.zeros((3, 2)), jnp.zeros((4, 2)))
    sched = optax.exponential_decay(1e-3, 1, 0.95, staircase=True)
    jstate = {"params": p, "opt_state": optax.adam(sched).init(p)}
    jckpt.save_state(os.path.join(tmp_path, "jax"), jstate)
    tp = lightgcn_params_from_jax(np.zeros((3, 2)), np.zeros((4, 2)), device="cpu")
    from laplace_gnn_recommendation_tpu_torch.train.adam import StaircaseAdam
    tckpt.save_state(os.path.join(tmp_path, "port"),
                     {"params": tp, "opt_state": StaircaseAdam(1e-3, 1).init(tp)})
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_checkpoint_version_rule_and_sharded_refusal(tmp_path):
    tp = lightgcn_params_from_jax(np.ones((3, 2)), np.ones((4, 2)), device="cpu")
    for name, scale in (("model_3", 3.0), ("model_12", 12.0), ("other_99", 99.0)):
        tckpt.save_state(os.path.join(tmp_path, name),
                         {"params": LightGCNParams(tp.user_emb * scale, tp.item_emb * scale)})
    state, ver = tckpt.load_latest(str(tmp_path), {"params": tp})
    assert ver == 12 and float(state["params"].user_emb[0, 0]) == 12.0
    tckpt.save_state(os.path.join(tmp_path, "model_final"),
                     {"params": LightGCNParams(tp.user_emb * 7, tp.item_emb * 7)})
    state, ver = tckpt.load_latest(str(tmp_path), {"params": tp})
    assert ver == 1 << 30 and float(state["params"].user_emb[0, 0]) == 7.0
    assert tckpt.load_latest(str(tmp_path / "none"), {"params": tp}) == ({"params": tp}, None)
    # sharded checkpoints are written on a mesh of several ranks
    # (tests/test_torch_parallel.py); without one the call is refused
    with pytest.raises(ValueError, match="mesh of several ranks"):
        tckpt.save_state(os.path.join(tmp_path, "model_20"), {"params": tp}, sharded=True)
    assert not os.path.exists(tmp_path / "model_20.npz")


def test_plain_tier_keeps_ordinary_autograd():
    _, tg = _graph_pair(20, 30, 20, 200)
    ue, ie = _tables(21, 30, 20, 8)
    u = torch.from_numpy(ue).requires_grad_()
    uf, itf = lightgcn_propagate(tg, u, torch.from_numpy(ie), 2)
    assert "SelfAdjoint" not in type(uf.grad_fn).__name__
    (uf.sum() + itf.sum()).backward()
    assert bool((u.grad != 0).any())
