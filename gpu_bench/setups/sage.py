"""The hetero SAGE ranking stack at H&M shape through the program's public
entries.

The benchmark makes the graph (``hm_graph``), an 80/10/10 split, the
categorical features and the weights from the seed on the card, and hands
the program what its types take: ``HostCSR`` adjacencies of the cumulative
splits, ``get_matchers``' matchers, a ``LinkPredData``, and the weights
through ``sage.load_jax_tree_``.

``train``: ``create_samplers``' train sampler feeding
``encdec_pipeline.make_train_step`` through ``data/prefetch`` (one
sampler thread, as ``run_pipeline`` runs it), over shuffled train users.
Set-up drives that one object through its first three steps; the reference
then follows them on the same batches, weights and dropout generator state.
The sampler's truncation counters, over set-up, the window and what the
prefetch drew ahead, are compared with 0: the configuration's pad budgets
promise that no batch is cut.
"""
from __future__ import annotations

import itertools
import threading

import numpy as np
import torch

from gpu_bench import hm_graph
from gpu_bench.reference import sage as ref

REF_STEPS = 3
CFG_KEYS = ("hidden_layer_size", "encoder_layer_output_size", "k", "num_gnn_layers",
            "num_linear_layers", "learning_rate", "conv_agg_type", "heterogeneous_prop_agg_type",
            "batch_size", "num_neighbors", "n_hop_neighbors", "num_workers",
            "candidate_pool_size", "positive_edges_ratio", "negative_edges_ratio", "batch_norm",
            "matchers", "p_dropout_features", "budget_probe", "max_edges_per_batch",
            "max_labels_per_user")
BATCH_KEYS = ("user_ids", "item_ids", "user_mask", "item_mask", "edge_src", "edge_dst",
              "edge_mask", "label_src", "label_dst", "label", "label_mask",
              "label_item_global", "seed_users", "seed_slots")


def _sub_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])


def _csr(rows: torch.Tensor, cols: torch.Tensor, num_rows: int, num_cols: int):
    """HostCSR of (row, col) pairs, sorted on the card by (row, col)."""
    from laplace_gnn_recommendation_tpu_torch.data.graph import HostCSR

    key = torch.sort(rows * num_cols + cols).values
    ptr = torch.zeros(num_rows + 1, dtype=torch.int64, device=rows.device)
    ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=num_rows), 0)
    return HostCSR(ptr.cpu().numpy(), (key % num_cols).to(torch.int32).cpu().numpy(),
                   num_rows, num_cols)


class _Data:
    def __init__(self, config: dict, seed: int, dev: torch.device, spans):
        from laplace_gnn_recommendation_tpu_torch.configs import Config
        from laplace_gnn_recommendation_tpu_torch.constants import NODE_ITEM, NODE_USER
        from laplace_gnn_recommendation_tpu_torch.data.graph import HeteroGraph
        from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import (
            LinkPredData, SplitAdjacency)
        from laplace_gnn_recommendation_tpu_torch.data.matchers import get_matchers

        g = config["graph"]
        nu, ni = int(g["num_users"]), int(g["num_items"])
        self.nu, self.ni = nu, ni
        self.cfg = Config(**{k: config[k] for k in CFG_KEYS})
        gen = torch.Generator(device=dev).manual_seed(_sub_seed(seed, 0))
        with spans.span("setup.edges"):
            eu, ei = hm_graph.generate(g, gen)
            perm = torch.randperm(eu.numel(), generator=gen, device=dev)
            rank = torch.empty_like(perm)
            rank[perm] = torch.arange(perm.numel(), device=dev)
            n_tr = int(round(float(g["train_share"]) * eu.numel()))
            n_va = int(round(float(g["val_share"]) * eu.numel()))
            f = config["features"]
            self.user_feats = torch.randint(0, int(f["cardinality"]), (nu, int(f["user_columns"])),
                                            generator=gen, device=dev)
            self.item_feats = torch.randint(0, int(f["cardinality"]), (ni, int(f["item_columns"])),
                                            generator=gen, device=dev)
        with spans.span("setup.adjacency"):
            splits = {}
            for name, cut in (("train", n_tr), ("val", n_tr + n_va), ("test", eu.numel())):
                m = rank < cut
                u, i = eu[m], ei[m]
                splits[name] = SplitAdjacency(user_csr=_csr(u, i, nu, ni), item_csr=_csr(i, u, ni, nu))
                if name == "train":
                    self.train_keys = (u * ni + i).cpu().numpy()   # sorted, as the edges are
        matchers = {s: get_matchers(self.cfg.matchers, self.cfg.candidate_pool_size,
                                    splits[s].user_csr, splits[s].item_csr) for s in ("val", "test")}
        graph = HeteroGraph(node_features={NODE_USER: self.user_feats.cpu().numpy().astype(np.int32),
                                           NODE_ITEM: self.item_feats.cpu().numpy().astype(np.int32)},
                            edges={}, num_nodes={NODE_USER: nu, NODE_ITEM: ni})
        self.data = LinkPredData(num_users=nu, num_items=ni, user_features=self.user_feats,
                                 item_features=self.item_feats, splits=splits, matchers=matchers,
                                 graph=graph)


def _weights(params, gen: torch.Generator) -> dict:
    """The benchmark's weights in the program's JAX-layout tree, drawn in two
    calls: embeddings normal(0, 1); linear maps uniform(±1/sqrt(fan_in));
    BatchNorm scale 1, bias 0."""
    from laplace_gnn_recommendation_tpu_torch.models import sage

    tree = ref.map_tree(lambda t: torch.empty_like(t.detach()), sage.jax_tree(params))
    emb = [t for tables in tree["embeddings"].values() for t in tables]
    lins = [(p, d["w"].shape[0]) for layer in tree["convs"] for c in layer.values()
            for d in c.values() for p in d.values()]
    lins += [(p, d["w"].shape[0]) for d in tree["decoder"] for p in d.values()]
    dev = gen.device
    z = torch.randn(sum(t.numel() for t in emb), generator=gen, device=dev)
    o = 0
    for t in emb:
        t.copy_(z[o: o + t.numel()].view_as(t))
        o += t.numel()
    u = torch.rand(sum(p.numel() for p, _ in lins), generator=gen, device=dev) * 2 - 1
    o = 0
    for p, fan_in in lins:
        p.copy_(u[o: o + p.numel()].view_as(p) / np.sqrt(max(fan_in, 1)))
        o += p.numel()
    for bn in tree["bn"].values():
        bn["scale"].fill_(1.0)
        bn["bias"].fill_(0.0)
    return tree


def _until(stop: threading.Event, it):
    for x in it:
        if stop.is_set():
            return
        yield x


def _counts(b, units: int, num_params: int) -> dict:
    """A batch's raw sizes: its valid user and item slots, edges and label
    pairs, beside the seed users it counts and the model's parameters."""
    return {"units": units, "user_slots": int(np.asarray(b.user_mask).sum()),
            "item_slots": int(np.asarray(b.item_mask).sum()),
            "edges": int(np.asarray(b.edge_mask).sum()),
            "labels": int(np.asarray(b.label_mask).sum()), "params": num_params}


def _norms(tree) -> list:
    return [float(t.detach().double().norm()) for _, t in ref.leaves(tree)]


def _leaf_gaps(prog, refn, ref_grad) -> list:
    """Per leaf |‖prog‖ − ‖ref‖| / max(‖ref leaf‖, median ‖ref leaf‖), the
    leaves whose reference gradient is under a thousandth of the median
    leaf's left out (the last layer's biases under BatchNorm)."""
    med_g, med = float(np.median(ref_grad)), float(np.median(refn))
    return [abs(p - r) / max(r, med, 1e-30) for p, r, g in zip(prog, refn, ref_grad)
            if g >= 1e-3 * med_g] or [0.0]


def _detail(names, losses, ref_losses, gnorm, ref_g, cnorm, ref_c, worst: int = 3):
    """The readings behind the compared numbers, on standard error: each
    step's loss on both sides and the leaves that differ most."""
    import sys

    print(f"detail loss program {losses} reference {ref_losses}", file=sys.stderr)
    for what, prog, refn in (("grad", gnorm, ref_g), ("change", cnorm, ref_c)):
        gaps = sorted(((abs(p - r) / max(r, 1e-30), n, p, r) for n, p, r in zip(names, prog, refn)),
                      reverse=True)[:worst]
        for g, n, p, r in gaps:
            print(f"detail {what} {n}: program {p!r} reference {r!r} (own gap {g:.3g})",
                  file=sys.stderr)


class Train:
    def __init__(self, config, traffic, seed, dev, spans, control=False):
        from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import create_samplers
        from laplace_gnn_recommendation_tpu_torch.data.prefetch import prefetch
        from laplace_gnn_recommendation_tpu_torch.models import sage
        from laplace_gnn_recommendation_tpu_torch.train.adam import B1, Adam
        from laplace_gnn_recommendation_tpu_torch.train.encdec_pipeline import make_train_step

        self.config, self.dev, self.control = config, dev, control
        d = self.d = _Data(config, seed, dev, spans)
        cfg = d.cfg
        with spans.span("setup.samplers"):
            self.sampler_seed = _sub_seed(seed, 1)
            train_s, _, _ = create_samplers(cfg, d.data, seed=self.sampler_seed)
        self.sampler = train_s
        gen_w = torch.Generator(device=dev).manual_seed(_sub_seed(seed, 2))
        params, self.bn = sage.init_sage_params(cfg, sage.get_feature_info(d.data.graph),
                                                float_dims=d.data.float_dims(), generator=gen_w,
                                                device=dev)
        tree0 = _weights(params, gen_w)
        sage.load_jax_tree_(params, tree0)
        self.tree0 = ref.map_tree(lambda t: t.cpu(), tree0)
        del tree0
        self.params = params
        self.num_params = sum(p.numel() for p in params.parameters())
        tx = Adam(cfg.learning_rate)
        self.opt = tx.init(sage.jax_tree(params))
        self.step_fn = make_train_step(cfg, d.data, tx)
        self.gen = torch.Generator(device=dev).manual_seed(_sub_seed(seed, 3))
        self.gen_state = self.gen.get_state()
        self.kept = []
        self.stop = threading.Event()

        def upload(b):
            if len(self.kept) < REF_STEPS:
                self.kept.append({k: np.asarray(getattr(b, k)) for k in BATCH_KEYS})
            return _counts(b, cfg.batch_size, self.num_params), b.to(dev)

        epochs = (b for _ in itertools.count() for b in train_s.epoch_batches(shuffle=True))
        self.feed = prefetch(_until(self.stop, epochs),
                             buffer_size=1, transform=upload)
        self.losses = []
        for n in range(REF_STEPS):
            self.step(spans)
            self.losses.append(float(self.last_loss))
            if n == 0:
                self.grad_norms = [x / (1 - B1) for x in _norms(self.opt[0].mu)]
        now = ref.map_tree(lambda t: t.detach().cpu(), sage.jax_tree(params))
        self.change_norms = [float((a - b).double().norm()) for (_, a), (_, b)
                             in zip(ref.leaves(now), ref.leaves(self.tree0))]
        self.degrees = np.diff(d.data.splits["train"].user_csr.row_ptr)
        self.user_feats, self.item_feats = d.user_feats.cpu(), d.item_feats.cpu()
        self.train_keys, self.ni = d.train_keys, d.ni
        self.cfg = cfg
        del self.d

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def step(self, spans) -> dict:
        with spans.span("sampler_wait"):
            counts, batch = next(self.feed)
        self.params, self.bn, self.opt, self.last_loss = self.step_fn(
            self.params, self.bn, self.opt, batch, self.gen)
        return counts

    def shapes(self, window) -> list:
        return window["step_shapes"]

    def free(self):
        self.stop.set()
        for _ in self.feed:   # let the sampler thread see the stop and end
            pass
        del self.feed, self.step_fn, self.params, self.opt, self.bn

    def check(self, window):
        dev = self.dev
        rng = np.random.default_rng(self.sampler_seed)
        users = np.arange(len(self.degrees))[self.degrees > 0]
        rng.shuffle(users)
        b = self.cfg.batch_size
        bad = sum(ref.batch_violations(kb, self.train_keys, self.ni, users[j * b:(j + 1) * b],
                                       self.cfg.num_neighbors * max(self.cfg.n_hop_neighbors - 1, 1))
                  for j, kb in enumerate(self.kept))
        batches = [{k: torch.from_numpy(v.astype(np.float32) if k == "label" else
                                        (v if v.dtype == bool else v.astype(np.int64))).to(dev)
                    for k, v in kb.items()} for kb in self.kept]
        tree0 = ref.map_tree(lambda t: t.to(dev), self.tree0)
        uf, itf = self.user_feats.to(dev), self.item_feats.to(dev)
        f32 = ref.train_steps(tree0, batches, uf, itf, self.config, self.gen_state.clone())
        if self.control:
            low = ref.train_steps(tree0, batches, uf, itf, self.config, self.gen_state.clone(),
                                  tf32=self.control == 1, half=self.control == 2)
            losses = low["loss"]
            gnorm = [float(g.double().norm()) for g in low["grad"].values()]
            cnorm = [float(c.double().norm()) for c in low["change"].values()]
        else:
            losses, gnorm, cnorm = self.losses, self.grad_norms, self.change_norms
        ref_g = [float(g.double().norm()) for g in f32["grad"].values()]
        ref_c = [float(c.double().norm()) for c in f32["change"].values()]
        _detail(list(f32["grad"]), losses, f32["loss"], gnorm, ref_g, cnorm, ref_c)
        # A ReLU input within f32 rounding of its kink may switch between
        # two sound f32 runs and move a few leaves' gradients by ~1e-4 (an
        # f64 witness sides with either run), and Adam's later steps carry
        # it on: the compared numbers are the first step's loss and the
        # median leaf's; the worst leaf's and every step's go to stderr.
        g_gaps, c_gaps = _leaf_gaps(gnorm, ref_g, ref_g), _leaf_gaps(cnorm, ref_c, ref_g)
        import sys

        print(f"detail worst leaf: grad_norm_gap {max(g_gaps)!r} change_norm_gap {max(c_gaps)!r}; "
              f"loss gap over all steps {max(abs(p - q) / abs(q) for p, q in zip(losses, f32['loss']))!r}",
              file=sys.stderr)
        lim = self.config["limits"]["train"]
        return [
            ("batch_violations", float(bad), 0.0),
            ("sampler_truncations", float(sum(self.sampler.truncations.values())), 0.0),
            ("loss_gap", abs(losses[0] - f32["loss"][0]) / abs(f32["loss"][0]), lim["loss_gap"]),
            ("grad_norm_gap", float(np.median(g_gaps)), lim["grad_norm_gap"]),
            ("change_norm_gap", float(np.median(c_gaps)), lim["change_norm_gap"]),
        ]


def train(config, traffic, seed, dev, spans, control=False):
    return Train(config, traffic, seed, dev, spans, control)
