"""Shared fixtures of the benchmark's own tests (run them from the
repository's root: ``python -m pytest gpu_bench/tests -q``).

Tests that need the card carry the ``requires_cuda`` marker and take the
``cuda_device`` fixture, which decides at run time, never at import, whether
a card is there, and skips with a reason where there is none."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# cells cut to a size a CPU test holds; widths, sampling and batches stay as
# configured (a ranking batch of fewer seeds makes one ReLU input that f32
# rounding puts on the other side of its kink weigh on every leaf)
TINY = {
    "lightgcn-hm": {"graph": {"num_users": 2000, "num_items": 600, "num_clusters": 20},
                    "batch_size": 512, "check_rows": 200},
    "sage-hm": {"graph": {"num_users": 2000, "num_items": 600, "num_clusters": 20,
                          "avg_degree": 12.0},
                "max_edges_per_batch": None, "max_labels_per_user": None},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "requires_cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return "cuda"


@pytest.fixture(scope="session")
def spec():
    from gpu_bench import harness

    return harness.load_spec()


def run_tiny(spec, workload, seed=2**31 + 77, seconds=0.5, control=False, device="cpu",
             over=None, trace=False):
    from gpu_bench import harness

    wl = harness.find_cell(spec, workload)
    return harness.run_cell(spec, workload, seed, seconds, trace, device=device,
                            config_override=over if over is not None else TINY[wl["config"]],
                            control=control)
