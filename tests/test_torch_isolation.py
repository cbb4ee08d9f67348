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
