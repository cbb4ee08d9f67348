"""Two ranks through the port's CLI equal one rank (the port's counterpart
of ``tests/test_multihost.py``).

Two real processes run ``python -m laplace_gnn_recommendation_tpu_torch.cli``
as a ``torchrun`` launch would start them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), on the CPU over gloo, with a ``file://`` rendezvous under
the test's temporary directory instead of a port; the CLI calls
``distributed_init`` and the pipelines build their 1×2 mesh from
``--mesh_data_axis`` / ``--mesh_model_axis``. Their ``FINAL_STATS`` must
agree with each other and with the same run in this process on one device:

* LightGCN: loss within 1e-4, recall@k within 1e-6 (JAX tolerances);
* the encoder-decoder in two legs — three epochs writing sharded
  checkpoints (``torch.distributed.checkpoint`` directories), then a resume
  to five — against the same two legs on one device (npz checkpoints).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ml_artifacts(tmp_path_factory):
    """A tiny ml-1m-format dataset, preprocessed once by the port."""
    raw = tmp_path_factory.mktemp("mh_raw")
    rng = np.random.default_rng(7)
    n_users, n_movies = 30, 24
    (raw / "users.dat").write_text(
        "\n".join(f"{i}::M::25::15::55117" for i in range(1, n_users + 1)) + "\n")
    (raw / "movies.dat").write_text("\n".join(
        f"{i}::Movie {i} (199{i % 10})::Comedy|Drama" for i in range(1, n_movies + 1)) + "\n")
    rows, ts = [], 956700000
    for u in range(1, n_users + 1):
        for m in rng.choice(np.arange(1, n_movies + 1), size=6, replace=False):
            ts += 100
            rows.append(f"{u}::{m}::4::{ts}")
    (raw / "ratings.dat").write_text("\n".join(rows) + "\n")

    art = str(tmp_path_factory.mktemp("mh_derived"))
    from laplace_gnn_recommendation_tpu_torch.configs import preprocessing_config
    from laplace_gnn_recommendation_tpu_torch.data import preprocess_movielens

    preprocess_movielens.preprocess(preprocessing_config, str(raw), art)
    return art


LIGHTGCN = dict(epochs=4, eval_every=2, batch_size=16, hidden_layer_size=8,
                num_iterations=2, k=4, num_recommendations=8)


def _enc_kw(epochs):
    return dict(epochs=epochs, eval_every=2, batch_size=8, hidden_layer_size=8,
                encoder_layer_output_size=8, n_hop_neighbors=2, num_neighbors=8, k=4,
                candidate_pool_size=8, save_model=True, save_every=0.34)


def _flags(kw):
    out = []
    for k, v in kw.items():
        out += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return out


def _run_pair(tmp_path, name, args):
    """The CLI on two ranks; their stdouts."""
    rdzv = tmp_path / f"rdzv_{name}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = []
    for rank in (0, 1):
        env_r = dict(env, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                     OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "laplace_gnn_recommendation_tpu_torch.cli", *args,
             "--device", "cpu", "--dist_init_method", f"file://{rdzv}",
             "--mesh_data_axis", "1", "--mesh_model_axis", "2"],
            env=env_r, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _final(outs):
    final = [json.loads(line.split("FINAL_STATS ", 1)[1])
             for out in outs for line in out.splitlines() if line.startswith("FINAL_STATS ")]
    assert len(final) == 2, outs[0][-2000:]
    assert final[0]["loss"] == pytest.approx(final[1]["loss"], abs=1e-6)
    return final[0]


def test_two_rank_lightgcn_cli_matches_one_rank(ml_artifacts, tmp_path):
    from laplace_gnn_recommendation_tpu_torch.configs import LightGCNConfig, link_pred_config
    from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import lightgcn_data_from_hetero
    from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import (
        create_link_pred_data_from_artifacts,
    )
    from laplace_gnn_recommendation_tpu_torch.train.lightgcn_pipeline import train

    bundle, _ = create_link_pred_data_from_artifacts(ml_artifacts, link_pred_config, device="cpu")
    data = lightgcn_data_from_hetero(bundle.graph, device="cpu")
    ref = train(LightGCNConfig(propagation="plain", **LIGHTGCN), data, export=False,
                log_fn=lambda *_: None, device="cpu")

    outs = _run_pair(tmp_path, "lightgcn", ["--type", "lightgcn", "--artifact_dir", ml_artifacts,
                                            *_flags(LIGHTGCN)])
    final = _final(outs)
    assert final["loss"] == pytest.approx(ref.loss, abs=1e-4)
    assert final["recall_test"] == pytest.approx(ref.recall_test, abs=1e-6)


def test_two_rank_encoder_cli_sharded_checkpoint_resume(ml_artifacts, tmp_path):
    from laplace_gnn_recommendation_tpu_torch.configs import Config
    from laplace_gnn_recommendation_tpu_torch.data.link_pred_data import (
        create_link_pred_data_from_artifacts,
    )
    from laplace_gnn_recommendation_tpu_torch.train.encdec_pipeline import run_pipeline

    one_dir = str(tmp_path / "one_rank")
    bundle, _ = create_link_pred_data_from_artifacts(ml_artifacts, Config(**_enc_kw(3)),
                                                     device="cpu")
    quiet = lambda *_: None  # noqa: E731
    run_pipeline(Config(**_enc_kw(3)), bundle, model_dir=one_dir, log_fn=quiet, device="cpu")
    ref = run_pipeline(Config(**_enc_kw(5)), bundle, model_dir=one_dir, resume=True,
                       log_fn=quiet, device="cpu")

    two_dir = str(tmp_path / "two_ranks")
    args = ["--type", "encoder", "--artifact_dir", ml_artifacts, "--model_dir", two_dir]
    _run_pair(tmp_path, "enc1", args + _flags(_enc_kw(3)))
    assert any(n.endswith(".dcp") for n in os.listdir(two_dir)), os.listdir(two_dir)
    outs = _run_pair(tmp_path, "enc2", args + _flags(_enc_kw(5)) + ["--resume"])
    assert all("Resuming from checkpoint" in out for out in outs), outs[0][-3000:]
    final = _final(outs)
    assert final["loss"] == pytest.approx(ref.loss, abs=1e-4)
    assert final["recall_test"] == pytest.approx(ref.recall_test, abs=1e-6)
