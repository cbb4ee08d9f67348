"""The hetero SAGE encoder-decoder of the PyTorch port against the JAX
package's ``models/sage.py`` on the same batch and the same weights
(``sage_params_from_jax``): ``encode``, ``decode`` and ``infer`` in eval
mode for add, mean and max aggregation on the dense and the segment path,
with the extra node type and with float features; train-mode BatchNorm
statistics; the gradient of every parameter leaf at dropout p=0; and
``bce_loss``.

Tolerances: the same f32 operations summed in another order — values
agree to rtol 1e-5 and an atol of 1e-5 or 1e-6 of the largest entry,
whichever is larger (``add`` sums reach a few hundred, where one f32 ulp is
3e-5, and an output near 0 can come from such terms; against an f64 run the
port's error is no larger than JAX's); gradients (largest entries ~1) to
rtol 1e-4, atol 1e-6. Under ``max`` a gradient reaches only the message that
holds a segment's maximum. Exact ties occur only among ReLU zeros in layer
2, whose gradient the ReLU stops in both packages, so the comparison does
not depend on how JAX and torch split a tied gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu.configs import Config as JConfig
from laplace_gnn_recommendation_tpu.data import link_pred_data as jlpd
from laplace_gnn_recommendation_tpu.data import synthetic as jsynth
from laplace_gnn_recommendation_tpu.models import sage as jsage
from laplace_gnn_recommendation_tpu_torch.configs import Config
from laplace_gnn_recommendation_tpu_torch.constants import NODE_ITEM, NODE_USER
from laplace_gnn_recommendation_tpu_torch.data import link_pred_data as tlpd
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
from laplace_gnn_recommendation_tpu_torch.models import sage
from laplace_gnn_recommendation_tpu_torch.train.checkpoint import tree_leaves_with_path

BASE = dict(batch_size=8, num_neighbors=16, n_hop_neighbors=2, hidden_layer_size=32,
            encoder_layer_output_size=16, k=6, candidate_pool_size=10,
            negative_edges_ratio=2.0, p_dropout_features=0.0, seed=5)
VARIANTS = {"plain": {}, "extra": {"num_extra": 5}, "float": {"float_dim": 12}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def build(variant="plain", **cfg_kw):
    """Both packages' data, one batch (oracle mode: identical arrays) and
    JAX params carried into the port."""
    v = VARIANTS[variant]
    gkw = dict(seed=4, num_users=60, num_items=50, avg_degree=6, num_extra=v.get("num_extra", 0))
    jg, tg = jsynth.random_hetero_graph(**gkw), random_hetero_graph(**gkw)
    if "float_dim" in v:
        f = np.random.default_rng(0).normal(size=(50, v["float_dim"])).astype(np.float32)
        jg.node_features_float[NODE_ITEM] = f
        tg.node_features_float[NODE_ITEM] = f
    jcfg, tcfg = JConfig(**dict(BASE, **cfg_kw)), Config(**dict(BASE, **cfg_kw))
    jd = jlpd.create_link_pred_data(jg, jcfg)
    td = tlpd.create_link_pred_data(tg, tcfg, device="cpu")
    jb = jlpd.create_samplers(jcfg, jd, randomization=False)[0].sample_batch(np.arange(8))
    tb = tlpd.create_samplers(tcfg, td, randomization=False)[0].sample_batch(np.arange(8))
    info = jsage.get_feature_info(jg)
    jp, jbn = jsage.init_sage_params(jax.random.PRNGKey(1), jcfg, info,
                                     float_dims=jd.float_dims(), num_extra=jd.num_extra)
    # non-trivial BatchNorm affine and running stats
    rng = np.random.default_rng(2)
    jp["bn"] = jax.tree.map(lambda x: x + rng.normal(size=x.shape).astype(np.float32) * 0.3,
                            jp["bn"])
    jbn = jax.tree.map(lambda x: x + np.abs(rng.normal(size=x.shape)).astype(np.float32) * 0.2,
                       jbn)
    tp, tbn = sage.sage_params_from_jax(_np(jp), _np(jbn), device="cpu")
    jkw = dict(user_features_float=jd.user_features_float,
               item_features_float=jd.item_features_float,
               item_extra_ids=jd.item_extra_ids, extra_features=jd.extra_features)
    tkw = dict(user_features_float=td.user_features_float,
               item_features_float=td.item_features_float,
               item_extra_ids=td.item_extra_ids, extra_features=td.extra_features)
    return dict(jcfg=jcfg, tcfg=tcfg, jd=jd, td=td, jb=jb, tb=tb.to("cpu"), jp=jp, jbn=jbn,
                tp=tp, tbn=tbn, jkw=jkw, tkw=tkw)


def close(a, b, rtol=1e-5, atol=None):
    a, b = (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    if atol is None:
        # the largest entry other than infer's pad slots
        atol = max(1e-5, 1e-6 * float(np.abs(b[b != sage.INFER_PAD]).max(initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_feature_info_equal():
    kw = dict(seed=4, num_users=60, num_items=50, avg_degree=6, num_extra=3)
    j = jsage.get_feature_info(jsynth.random_hetero_graph(**kw))
    t = sage.get_feature_info(random_hetero_graph(**kw))
    assert {k: vars(v) for k, v in j.items()} == {k: vars(v) for k, v in t.items()}
    assert sage.INFER_PAD == jsage.INFER_PAD


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("layers", [(2, 2), (3, 1)])
def test_init_tree_matches_jax(variant, layers):
    """``init_sage_params`` builds the JAX params tree's shapes (the port's
    draws are its own), and the converter round-trips a JAX tree."""
    s = build(variant, num_gnn_layers=layers[0], num_linear_layers=layers[1])
    info = sage.get_feature_info(s["td"].graph)
    tp, tbn = sage.init_sage_params(s["tcfg"], info, float_dims=s["td"].float_dims(),
                                    num_extra=s["td"].num_extra, device="cpu")
    jleaves = dict(tree_leaves_with_path(_np(s["jp"])))
    tleaves = dict(tree_leaves_with_path(sage.jax_tree(tp)))
    assert sorted(jleaves) == sorted(tleaves)
    for k in jleaves:
        assert tuple(jleaves[k].shape) == tuple(tleaves[k].shape), k
    # linear layers: uniform within ±1/sqrt(fan_in), as torch.nn.Linear
    w = sage.jax_tree(tp)["decoder"][0]["w"].detach()
    assert float(w.abs().max()) <= 1 / np.sqrt(w.shape[0])
    assert sorted(tbn) == sorted(s["jbn"])
    for k, v in tree_leaves_with_path(sage.jax_tree(s["tp"])):
        np.testing.assert_array_equal(v.detach().numpy(), jleaves[k])
    # nn.Linear holds the transpose of the JAX [fan_in, fan_out] weight
    assert s["tp"].decoder[0].weight.shape == jleaves["['decoder']/[0]/['w']"].shape[::-1]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("budget", [256 << 20, 0], ids=["dense", "segment"])
@pytest.mark.parametrize("agg", ["add", "mean", "max"])
def test_eval_forward_matches_jax(agg, budget, variant):
    s = build(variant, conv_agg_type=agg, dense_bytes_budget=budget)
    jzu, jzi, _ = jsage.encode(s["jp"], s["jbn"], s["jb"], s["jd"].user_features,
                               s["jd"].item_features, s["jcfg"], **s["jkw"])
    tzu, tzi, tbn = sage.encode(s["tp"], s["tbn"], s["tb"], s["td"].user_features,
                                s["td"].item_features, s["tcfg"], **s["tkw"])
    # eval mode leaves the running stats
    assert all(tbn[t][k] is s["tbn"][t][k] for t in tbn for k in tbn[t])
    close(tzu, jzu)
    close(tzi, jzi)
    close(sage.decode(s["tp"], tzu, tzi, s["tb"], s["tcfg"]),
          jsage.decode(s["jp"], jzu, jzi, s["jb"], s["jcfg"]))
    ji = jsage.infer(s["jp"], s["jbn"], s["jb"], s["jd"].user_features, s["jd"].item_features,
                     s["jcfg"], **s["jkw"])
    ti = sage.infer(s["tp"], s["tbn"], s["tb"], s["td"].user_features, s["td"].item_features,
                    s["tcfg"], **s["tkw"])
    close(ti, ji)
    assert (ti[~s["tb"].label_mask] == sage.INFER_PAD).all()


@pytest.mark.parametrize("combine", ["mean", "min", "max", "mul"])
def test_hetero_combine_matches_jax(combine):
    s = build("extra", heterogeneous_prop_agg_type=combine, dense_bytes_budget=0)
    ji = jsage.infer(s["jp"], s["jbn"], s["jb"], s["jd"].user_features, s["jd"].item_features,
                     s["jcfg"], **s["jkw"])
    ti = sage.infer(s["tp"], s["tbn"], s["tb"], s["td"].user_features, s["td"].item_features,
                    s["tcfg"], **s["tkw"])
    close(ti, ji)


def _jax_grads(s):
    def loss_fn(p):
        logits, new_bn = jsage.forward(p, s["jbn"], s["jb"], s["jd"].user_features,
                                       s["jd"].item_features, s["jcfg"], train=True,
                                       rng=jax.random.PRNGKey(0), **s["jkw"])
        return jsage.bce_loss(logits, s["jb"]), new_bn

    (loss, new_bn), grads = jax.value_and_grad(loss_fn, has_aux=True)(s["jp"])
    return float(loss), _np(new_bn), _np(grads)


def _port_grads(s):
    logits, new_bn = sage.forward(s["tp"], s["tbn"], s["tb"], s["td"].user_features,
                                  s["td"].item_features, s["tcfg"], train=True,
                                  generator=torch.Generator().manual_seed(0), **s["tkw"])
    loss = sage.bce_loss(logits, s["tb"])
    loss.backward()
    return float(loss.detach()), new_bn, dict(tree_leaves_with_path(sage.grad_tree(s["tp"])))


@pytest.mark.parametrize("variant", ["plain", "extra"])
@pytest.mark.parametrize("budget", [256 << 20, 0], ids=["dense", "segment"])
@pytest.mark.parametrize("agg", ["add", "mean", "max"])
def test_gradients_match_jax(agg, budget, variant):
    """Train mode at p=0: the loss, the new BatchNorm running statistics
    (masked batch mean and the n/(n−1)-corrected variance) and the gradient
    of every parameter leaf."""
    s = build(variant, conv_agg_type=agg, dense_bytes_budget=budget)
    jloss, jbn, jgrads = _jax_grads(s)
    tloss, tbn, tgrads = _port_grads(s)
    assert abs(jloss - tloss) < 1e-5
    for t in (NODE_USER, NODE_ITEM):
        for k in ("mean", "var"):
            close(tbn[t][k], jbn[t][k])
    jleaves = dict(tree_leaves_with_path(jgrads))
    assert sorted(jleaves) == sorted(tgrads)
    zero = set()
    for k, g in jleaves.items():
        close(tgrads[k], g, rtol=1e-4, atol=1e-6)
        if not np.abs(g).max() > 0:
            zero.add(k)
    # every leaf learns but the last layer's item→extra conv, whose output
    # no later layer reads
    last = len(s["jp"]["convs"]) - 1
    assert all(k.startswith(f"['convs']/[{last}]/['item_to_extra']") for k in zero), zero


def test_bce_loss_matches_jax():
    s = build()
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=s["jb"].label.shape) * 4).astype(np.float32)
    close(sage.bce_loss(torch.from_numpy(logits), s["tb"]), jsage.bce_loss(logits, s["jb"]),
          rtol=1e-6, atol=1e-7)
    zero = float(sage.bce_loss(torch.zeros_like(s["tb"].label), s["tb"]))
    assert abs(zero - float(np.log(2.0))) < 1e-6  # BCE at logit 0


def test_max_aggregation_empty_segments_are_zero():
    msgs = torch.tensor([[1.0, -2.0], [3.0, -1.0], [5.0, 5.0]])
    dst = torch.tensor([0, 0, 2])
    valid = torch.tensor([True, True, False])
    out = sage._aggregate(msgs, dst, valid, 4, "max")
    np.testing.assert_array_equal(out.numpy(), [[3, -1], [0, 0], [0, 0], [0, 0]])
    ref = jsage._aggregate(jnp.asarray(msgs.numpy()), jnp.asarray(dst.numpy()),
                           jnp.asarray(valid.numpy()), 4, "max")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_dense_adjacency_counts_duplicate_edges():
    """A duplicated subgraph edge weighs twice on the dense path, as on the
    segment path (``index_put_`` with ``accumulate=True``)."""
    s = build(conv_agg_type="add")
    b = s["tb"]
    n = int(b.edge_mask.sum())
    b.edge_src[n], b.edge_dst[n], b.edge_mask[n] = b.edge_src[0], b.edge_dst[0], True
    outs = []
    for budget in (256 << 20, 0):
        cfg = Config(**BASE, conv_agg_type="add", dense_bytes_budget=budget)
        outs.append(sage.infer(s["tp"], s["tbn"], b, s["td"].user_features,
                               s["td"].item_features, cfg))
    close(outs[0], outs[1])


def test_dropout_draws_from_the_generator():
    s = build(p_dropout_features=0.5)

    def run(seed):
        logits, _ = sage.forward(s["tp"], s["tbn"], s["tb"], s["td"].user_features,
                                 s["td"].item_features, s["tcfg"], train=True,
                                 generator=torch.Generator().manual_seed(seed))
        return logits.detach()

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    # eval mode never drops
    a = sage.infer(s["tp"], s["tbn"], s["tb"], s["td"].user_features, s["td"].item_features,
                   s["tcfg"])
    np.testing.assert_array_equal(a.detach().numpy(), sage.infer(
        s["tp"], s["tbn"], s["tb"], s["td"].user_features, s["td"].item_features,
        s["tcfg"]).detach().numpy())


def test_module_call_is_forward():
    s = build()
    a, _ = s["tp"](s["tbn"], s["tb"], s["td"].user_features, s["td"].item_features, s["tcfg"])
    b, _ = sage.forward(s["tp"], s["tbn"], s["tb"], s["td"].user_features,
                        s["td"].item_features, s["tcfg"])
    assert torch.equal(a, b)
    # the renorm at lookup never rewrites the tables
    before = [t.detach().clone() for t in s["tp"].embeddings[NODE_USER]]
    sage.infer(s["tp"], s["tbn"], s["tb"], s["td"].user_features, s["td"].item_features,
               s["tcfg"])
    for x, y in zip(before, s["tp"].embeddings[NODE_USER]):
        assert torch.equal(x, y.detach()) and float(y.detach().norm(dim=1).max()) > 1


@pytest.mark.parametrize("n,rows,width", [(1, 1, 3), (33, 1, 2), (1000, 7, 4), (200, 300, 2),
                                          (64, 2, 1)])
def test_sorted_sum_matches_index_add(n, rows, width):
    """The port's sorted segment sums (runs longer than ``PIECE_ROWS``, rows
    with no index) against ``index_add_`` in f64 (sums in another order:
    1e-12), the same bits on a second call, and both Functions built on it
    against finite differences."""
    rng = np.random.default_rng(n)
    idx = torch.from_numpy(rng.integers(0, rows, n))
    v = torch.from_numpy(rng.normal(size=(n, width)))
    ref = torch.zeros(rows, width, dtype=torch.float64).index_add_(0, idx, v)
    out = sage._SumPlan(idx, rows).sum(v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(out, sage._SumPlan(idx, rows).sum(v))
    few = idx[:40] % 9   # finite differences stay cheap
    table = torch.from_numpy(rng.normal(size=(9, width))).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: sage._rows(t, few.view(-1, 1)), (table,))
    assert torch.autograd.gradcheck(lambda x: sage._SegmentSum.apply(x, sage._SumPlan(few, 9)),
                                    (v[:40].clone().requires_grad_(),))
