"""LightGCN at H&M shape through the program's public entries.

``train``: one ``make_train_step`` object (kernel A's tier as ``auto``
picks it), driven from the seed through its first three steps in set-up
and handed as it is to the window. The reference then follows those three
steps from the same E⁰ tables and generator state.

``serve``: a ``RetrievalServer`` over the tables of one plain f32 forward
of the seeded E⁰ (made by the benchmark, handed to both the server and the
reference), excluding the train edges.

Both build the graph from the seed on the card (``hm_graph``) and hand the
program host arrays where it takes them.
"""
from __future__ import annotations


import numpy as np
import torch

from gpu_bench import hm_graph
from gpu_bench.reference import lightgcn as ref

REF_STEPS = 3
CFG_KEYS = ("hidden_layer_size", "num_iterations", "batch_size", "learning_rate", "Lambda",
            "lr_decay_every", "bpr_variant", "propagation", "k")


def _sub_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])


class _Inputs:
    """The train edges, sorted by (user, item), and the E⁰ tables, all made
    on the card from the seed."""

    def __init__(self, config: dict, seed: int, dev: torch.device, spans):
        g = config["graph"]
        self.nu, self.ni, self.d = int(g["num_users"]), int(g["num_items"]), int(config["hidden_layer_size"])
        gen = torch.Generator(device=dev).manual_seed(_sub_seed(seed, 0))
        with spans.span("setup.edges"):
            eu, ei = hm_graph.generate(g, gen)
            keep = hm_graph.split_mask(eu.numel(), gen, float(g["train_share"]))
            self.eu, self.ei = eu[keep], ei[keep]
            std = float(config["init_std"])
            self.user0 = torch.randn((self.nu, self.d), generator=gen, device=dev) * std
            self.item0 = torch.randn((self.ni, self.d), generator=gen, device=dev) * std

    def host_edges(self):
        return self.eu.to(torch.int32).cpu().numpy(), self.ei.to(torch.int32).cpu().numpy()

    def degrees(self) -> np.ndarray:
        return torch.bincount(self.eu, minlength=self.nu).cpu().numpy()


def _gap(prog: float, refv: float, scale: float) -> float:
    return abs(prog - refv) / max(scale, 1e-30)


def _leaf_gaps(prog_norms, ref_norms, ref_grad_norms):
    """Worst leaf's |‖prog‖ − ‖ref‖| / max(‖ref leaf‖, median ‖ref leaf‖),
    leaves whose reference gradient is under a thousandth of the median
    leaf's left out."""
    med_g = float(np.median(ref_grad_norms))
    med = float(np.median(ref_norms))
    gaps = [_gap(p, r, max(r, med)) for p, r, g in zip(prog_norms, ref_norms, ref_grad_norms)
            if g >= 1e-3 * med_g]
    return max(gaps) if gaps else 0.0


class Train:
    def __init__(self, config, traffic, seed, dev, spans, control=False):
        from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig
        from laplace_gnn_recommendation_tpu_torch.data.graph import BipartiteGraph
        from laplace_gnn_recommendation_tpu_torch.models.lightgcn import LightGCNParams
        from laplace_gnn_recommendation_tpu_torch.train import lightgcn_pipeline as lp
        from laplace_gnn_recommendation_tpu_torch.train.adam import B1

        self.config, self.dev, self.control = config, dev, control
        self.inp = inp = _Inputs(config, seed, dev, spans)
        cfg = LightGCNConfig(**{k: config[k] for k in CFG_KEYS})
        self.batch = cfg.batch_size
        with spans.span("setup.graph"):
            graph = BipartiteGraph.from_edges(*inp.host_edges(), inp.nu, inp.ni, device=dev)
        with spans.span("setup.plans"):
            prop = lp.select_propagation(cfg, graph)
        gather = config["dtypes"]["propagation_gather"]
        if dev.type == "cuda" and getattr(prop, "gather_bf16", None) != (gather == "bf16"):
            raise RuntimeError(f"the program's propagation does not gather in {gather}, "
                               "as the configuration states")
        self.num_edges = graph.num_edges
        max_deg = int(graph.user_deg.max())
        self.step_fn, tx = lp.make_train_step(cfg, graph, max_deg, prop_graph=prop, device=dev)
        self.params = LightGCNParams(inp.user0.clone(), inp.item0.clone())
        self.opt = tx.init(self.params)
        self.gen = torch.Generator(device=dev).manual_seed(_sub_seed(seed, 1))
        self.gen_state = self.gen.get_state()
        self._graph, self._prop = graph, prop
        self.step_shape = {"units": self.batch, "batch": self.batch, "edges": self.num_edges,
                           "users": inp.nu, "items": inp.ni, "width": cfg.hidden_layer_size,
                           "hops": cfg.num_iterations, "gather": gather}

        # the first steps, read as the reference will follow them
        self.losses = []
        for n in range(REF_STEPS):
            self.params, self.opt, loss = self.step_fn(self.params, self.opt, self.gen)
            self.losses.append(float(loss))
            if n == 0:
                mu = self.opt[0].mu
                self.grad_norms = [float(mu.user_emb.double().norm() / (1 - B1)),
                                   float(mu.item_emb.double().norm() / (1 - B1))]
        self.change_norms = [float((self.params.user_emb - inp.user0).double().norm()),
                             float((self.params.item_emb - inp.item0).double().norm())]
        # the reference's inputs wait on the host while the window runs
        self.ref_in = {k: getattr(inp, k).cpu() for k in ("eu", "ei", "user0", "item0")}
        del self.inp.user0, self.inp.item0

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def step(self, spans) -> dict:
        self.params, self.opt, _ = self.step_fn(self.params, self.opt, self.gen)
        return self.step_shape

    def shapes(self, window) -> list:
        return window["step_shapes"]

    def free(self):
        del self.step_fn, self.params, self.opt, self._graph, self._prop

    def check(self, window):
        dev = self.dev
        r = {k: v.to(dev) for k, v in self.ref_in.items()}
        args = (r["eu"], r["ei"], self.inp.nu, self.inp.ni, r["user0"], r["item0"],
                self.config, self.gen_state.clone())
        f32 = ref.train_steps(*args, REF_STEPS)
        if self.control:   # the reference, one precision below or half-batch, in the program's place
            low = ref.train_steps(*args, REF_STEPS, lower=self.control == 1, half=self.control == 2)
            losses, gnorm, cnorm = (low["loss"], [float(g.double().norm()) for g in low["grad"]],
                                    [float(c.double().norm()) for c in low["change"]])
        else:
            losses, gnorm, cnorm = self.losses, self.grad_norms, self.change_norms
        ref_g = [float(g.double().norm()) for g in f32["grad"]]
        ref_c = [float(c.double().norm()) for c in f32["change"]]
        lim = self.config["limits"]["train"]
        return [
            ("loss_gap", max(_gap(p, q, abs(q)) for p, q in zip(losses, f32["loss"])), lim["loss_gap"]),
            ("grad_norm_gap", _leaf_gaps(gnorm, ref_g, ref_g), lim["grad_norm_gap"]),
            ("change_norm_gap", _leaf_gaps(cnorm, ref_c, ref_g), lim["change_norm_gap"]),
        ]


class Serve:
    def __init__(self, config, traffic, seed, dev, spans, control=False):
        from laplace_gnn_recommendation_tpu_torch.serving import RetrievalServer

        self.config, self.dev, self.control = config, dev, control
        inp = _Inputs(config, seed, dev, spans)
        self.nu, self.ni, self.k = inp.nu, inp.ni, int(config["k"])
        with spans.span("setup.tables"):
            w = ref.edge_weights(inp.eu, inp.ei, inp.nu, inp.ni)
            with torch.no_grad():
                uf, itf = ref.propagate(inp.eu, inp.ei, w, inp.user0, inp.item0,
                                        int(config["num_iterations"]))
            del w
        self.deg = inp.degrees()
        with spans.span("setup.server"):
            self.server = RetrievalServer(uf, itf, k=self.k, exclude_edges=inp.host_edges(),
                                          batch_size=int(config["serve_batch"]), device=dev)
        self.rng_seed = _sub_seed(seed, 2)
        self.row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                                  torch.cumsum(torch.bincount(inp.eu, minlength=inp.nu), 0)])
        self.ex_items = inp.ei
        self.uf, self.itf = uf, itf
        # warm every shape the traffic uses: one batch shape, full and padded
        self.request(np.arange(int(config["serve_batch"]) + 1), spans)
        self.sync()

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def num_users(self) -> int:
        return self.nu

    def request(self, users, spans):
        if self.control:
            u = torch.from_numpy(np.asarray(users, np.int64)).to(self.dev)
            ids, vals = ref.topk_answer(self.uf[u], self.itf, self.row_ptr, self.ex_items, u,
                                        self.k, tf32=True)
            return ids.cpu().numpy(), vals.cpu().numpy()
        return self.server.recommend(users)

    def shapes(self, window) -> list:
        d = int(self.config["hidden_layer_size"])
        return [{"users": len(users), "items": self.ni, "width": d, "k": self.k,
                 "excluded": int(self.deg[users].sum())} for users, _ in window["answers"]]

    def free(self):
        del self.server

    def check(self, window):
        """Served ids and scores of a sample drawn from the seed (the
        longest request among them) against the f32 reference."""
        answers = window["answers"]
        lim = self.config["limits"]["serve"]
        if not answers:
            return [("answers", 1.0, 0.0)]
        rng = np.random.default_rng(self.rng_seed)
        order = [int(np.argmax([len(u) for u, _ in answers]))]
        order += [int(i) for i in rng.permutation(len(answers)) if i != order[0]]
        budget, rows = int(self.config["check_rows"]), 0
        wrong, gap, err = 0, 0.0, 0.0
        for i in order:
            if rows >= budget:
                break
            users, (ids, vals) = answers[i]
            u = torch.from_numpy(np.asarray(users, np.int64)).to(self.dev)
            for s in range(0, len(users), 1024):
                sl = slice(s, s + 1024)
                w_, g_, e_ = ref.judge_topk(
                    self.uf[u[sl]], self.itf, self.row_ptr, self.ex_items, u[sl],
                    torch.from_numpy(np.asarray(ids[sl])).to(self.dev),
                    torch.from_numpy(np.asarray(vals[sl])).to(self.dev), self.k)
                wrong, gap, err = wrong + w_, max(gap, g_), max(err, e_)
            rows += len(users)
        return [("wrong_ids", float(wrong), 0.0), ("rank_gap", gap, lim["rank_gap"]),
                ("score_err", err, lim["score_err"])]


def train(config, traffic, seed, dev, spans, control=False):
    return Train(config, traffic, seed, dev, spans, control)


def serve(config, traffic, seed, dev, spans, control=False):
    return Serve(config, traffic, seed, dev, spans, control)
