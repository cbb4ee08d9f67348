"""PinSAGE training repeats across processes: ``pinsage_pipeline.train`` at
a tiny size, run with one seed in two fresh interpreters that hash strings
differently (``PYTHONHASHSEED``), must report the same losses and HITS@k,
on the native frontier and on the Python one. (Set or dict iteration order
that hashing changes, or a prefetch thread that reorders batches, would
show here.)"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import json, sys
import numpy as np
from laplace_gnn_recommendation_tpu_torch.data.etl import LinkPredArtifacts
from laplace_gnn_recommendation_tpu_torch.data.pinsage_data import build_pinsage_data
from laplace_gnn_recommendation_tpu_torch.data.splitting import train_test_split_by_time
from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_hetero_graph
from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
from laplace_gnn_recommendation_tpu_torch.train import pinsage_pipeline as P

g = random_hetero_graph(seed=9, num_users=60, num_items=45, avg_degree=8)
tr, va, te = train_test_split_by_time(g.edges[EDGE_KEY][0])
data = build_pinsage_data(LinkPredArtifacts(g, tr, va, te, {}, {}))
real, samplers = P.PinSAGESampler, []

def make_sampler(*a, **k):
    samplers.append(real(*a, **dict(k, use_native=sys.argv[1] == "native")))
    return samplers[-1]

P.PinSAGESampler = make_sampler
losses = []
cfg = P.PinSAGEConfig(num_epochs=2, batches_per_epoch=6, batch_size=8, hidden_dims=8,
                      num_neighbors=3, k=5, lr=3e-3, seed=4)
out = P.train(cfg, data, log_fn=losses.append, device="cpu")
print("RESULT " + json.dumps(dict(loss=out["loss"], val_hits=out["val_hits"],
                                  test_hits=out["test_hits"], log=losses,
                                  path=samplers[0].path)))
"""


def _run(hashseed, frontier):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, PYTHONHASHSEED=str(hashseed), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", SCRIPT, frontier], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line.split(" ", 1)[1])


@pytest.mark.parametrize("frontier", ["native", "python"])
def test_train_repeats_across_processes(frontier):
    a, b = _run(0, frontier), _run(12345, frontier)
    assert a == b
    assert a["path"] == frontier
    assert a["loss"] is not None and a["test_hits"] is not None
