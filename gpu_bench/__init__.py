"""The benchmark of the PyTorch and CUDA package
(``laplace_gnn_recommendation_tpu_torch``): run one cell with
``python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the repository's root. ``BENCHMARK.json`` names the cells."""
