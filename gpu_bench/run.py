"""Run one cell of the benchmark:

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with the cards the cell asks for.
The last line of standard output is the result as one JSON object; the
numbers the correctness check compared, each beside its limit, are the last
lines of standard error. Exits non-zero, with no result, when it cannot
measure (no card, too few cards, a missing piece, JAX loaded).
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "_bench_cache", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from gpu_bench.harness import main

    sys.exit(main(t_start=T_START))
