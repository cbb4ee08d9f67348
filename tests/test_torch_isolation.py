"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package, its kernel modules import without ``nvcc`` or a card, its entry
points default to the card and raise where there is none, and
``chip_smoke.py`` refuses to report a result without a card or outside a
checkout."""
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import laplace_gnn_recommendation_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + ".")
    )


def _run(code_or_args, cwd=REPO, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO if cwd == REPO else ""
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else [sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_package_imports_no_jax():
    mods = _modules()
    assert "laplace_gnn_recommendation_tpu_torch.ops.topk_pallas" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'laplace_gnn_recommendation_tpu'\n"
        "             or n.startswith('laplace_gnn_recommendation_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "from laplace_gnn_recommendation_tpu_torch import native\n"
        "assert not native._state  # the sampler library builds at first use\n"
        "print('ok', len(sys.modules))\n"
    )
    r = _run(code)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stderr


def test_importing_builds_nothing():
    from laplace_gnn_recommendation_tpu_torch import _build

    assert not _build._libs and not _build.build_log


def _cfg():
    from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig

    return LightGCNConfig(epochs=1, hidden_layer_size=4, batch_size=8, num_iterations=1)


def _cpu_data():
    from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import create_lightgcn_data

    return create_lightgcn_data(np.arange(40) % 8, np.arange(40) % 5, 8, 5, device="cpu")


def _train_on_default_device():
    from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import train

    return train(_cfg(), _cpu_data(), export=False, log_fn=lambda *_: None)


def _ranking_cfg():
    from laplace_gnn_recommendation_tpu_torch.configs import Config

    return Config(epochs=1, batch_size=4, num_neighbors=4, n_hop_neighbors=1,
                  hidden_layer_size=4, encoder_layer_output_size=4, k=2)


def _ranking_on_default_device(what):
    from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import create_link_pred_data
    from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
    from laplace_gnn_recommendation_tpu_torch.models import sage
    from laplace_gnn_recommendation_tpu_torch.train.encdec_pipeline import run_pipeline

    g = random_hetero_graph(seed=0, num_users=12, num_items=9, avg_degree=3)
    if what == "create_link_pred_data":
        return create_link_pred_data(g, _ranking_cfg())
    if what == "init_sage_params":
        return sage.init_sage_params(_ranking_cfg(), sage.get_feature_info(g))
    data = create_link_pred_data(g, _ranking_cfg(), device="cpu")
    return run_pipeline(_ranking_cfg(), data, log_fn=lambda *_: None)


def _pinsage_data():
    from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
    from laplace_gnn_recommendation_tpu_torch.data.etl import LinkPredArtifacts
    from laplace_gnn_recommendation_tpu_torch.data.pinsage_data import build_pinsage_data
    from laplace_gnn_recommendation_tpu_torch.data.splitting import train_test_split_by_time
    from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph

    g = random_hetero_graph(seed=0, num_users=12, num_items=9, avg_degree=3)
    tr, va, te = train_test_split_by_time(g.edges[EDGE_KEY][0])
    return build_pinsage_data(LinkPredArtifacts(g, tr, va, te, {}, {}))


def _pinsage_on_default_device(what):
    from laplace_gnn_recommendation_tpu_torch.models import pinsage
    from laplace_gnn_recommendation_tpu_torch.train import pinsage_pipeline as pp

    if what == "init_pinsage_params":
        return pinsage.init_pinsage_params(9, [3], 4, 1)
    if what == "hits_at_k":
        return pp.hits_at_k(_pinsage_data(), np.zeros((9, 4), np.float32), 2)
    return pp.train(pp.PinSAGEConfig(num_epochs=1, batches_per_epoch=1), _pinsage_data(),
                    log_fn=lambda *_: None)


ENTRY_POINTS = {
    "BipartiteGraph.from_edges": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.data.graph", fromlist=["x"]
    ).BipartiteGraph.from_edges(np.array([0]), np.array([0]), 1, 1),
    "create_lightgcn_data": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.data.lightgcn_data", fromlist=["x"]
    ).create_lightgcn_data(np.arange(20) % 4, np.arange(20) % 5, 4, 5),
    "init_lightgcn": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.models.lightgcn", fromlist=["x"]
    ).init_lightgcn(3, 4, 8),
    "lightgcn_params_from_jax": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.models.lightgcn", fromlist=["x"]
    ).lightgcn_params_from_jax(np.zeros((3, 2)), np.zeros((4, 2))),
    "RetrievalServer": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.serving", fromlist=["x"]
    ).RetrievalServer(np.zeros((3, 2)), np.zeros((4, 2)), k=2),
    "train": lambda: _train_on_default_device(),
    "make_train_step": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline", fromlist=["x"]
    ).make_train_step(_cfg(), _cpu_data().train_graph, 1),
    "create_link_pred_data": lambda: _ranking_on_default_device("create_link_pred_data"),
    "init_sage_params": lambda: _ranking_on_default_device("init_sage_params"),
    "run_pipeline": lambda: _ranking_on_default_device("run_pipeline"),
    "sage_params_from_jax": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.models.sage", fromlist=["x"]
    ).sage_params_from_jax({"embeddings": {}, "convs": [], "decoder": []}, {}),
    "HeteroGraph.bipartite": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.data.synthetic", fromlist=["x"]
    ).random_hetero_graph(0, 4, 3).bipartite(__import__(
        "laplace_gnn_recommendation_tpu_torch.constants", fromlist=["x"]).EDGE_KEY),
    "init_pinsage_params": lambda: _pinsage_on_default_device("init_pinsage_params"),
    "pinsage_params_from_jax": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.models.pinsage", fromlist=["x"]
    ).pinsage_params_from_jax({"proj": {"tables": [], "id_table": np.zeros((3, 2))},
                               "convs": [], "bias": np.zeros(3)}),
    "pinsage_pipeline.hits_at_k": lambda: _pinsage_on_default_device("hits_at_k"),
    "pinsage_pipeline.train": lambda: _pinsage_on_default_device("train"),
    "create_link_pred_data_from_artifacts": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.data.link_pred_data", fromlist=["x"]
    ).create_link_pred_data_from_artifacts("no-such-dir", _ranking_cfg()),
    "RetrievalServer.quantized": lambda: __import__(
        "laplace_gnn_recommendation_tpu_torch.serving", fromlist=["x"]
    ).RetrievalServer(np.zeros((3, 2)), np.zeros((4, 2)), k=2, quantized=True),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_native_pinsage_bindings_need_no_card():
    """The PinSAGE frontier and walk step are host code: they import and run
    without a card (and without building anything at import)."""
    code = (
        "import numpy as np\n"
        "from laplace_gnn_recommendation_tpu_torch import native\n"
        "assert not native._state\n"
        "assert callable(native.pinsage_frontier) and callable(native.walk_step)\n"
        "if native.available():\n"
        "    ptr = np.array([0, 2, 3], np.int64); cols = np.array([0, 1, 1], np.int32)\n"
        "    iptr = np.array([0, 1, 3], np.int64); icols = np.array([0, 0, 1], np.int32)\n"
        "    src, dst, w = native.pinsage_frontier(ptr, cols, iptr, icols, np.array([0, 1]),\n"
        "                                          2, 0.5, 10, 3, 1)\n"
        "    assert src.dtype == dst.dtype == np.int64 and (w > 0).all()\n"
        "    out = native.walk_step(ptr, cols, iptr, icols, np.array([0, -1, 1]), 2)\n"
        "    assert out.dtype == np.int64 and out[1] == -1 and (out[[0, 2]] >= 0).all()\n"
        "import sys; assert 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    r = _run(code, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_wrappers_refuse_other_devices():
    from laplace_gnn_recommendation_tpu_torch.ops import spmm_pallas, topk_pallas

    meta = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        topk_pallas.streaming_mips_topk(meta, meta, 1)
    plan = spmm_pallas.PallasSegmentPlan.from_edges(
        np.array([0]), np.array([0]), np.ones(1, np.float32), 1
    )
    with pytest.raises(ValueError, match="unsupported device"):
        spmm_pallas.pallas_segment_sum(plan, meta)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run([sys.executable, "chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    r = _run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
