"""Compute ops: SpMM tiers, top-k MIPS, metrics. Kernel wrappers live in
``spmm_pallas.py`` and ``topk_pallas.py`` (named after the JAX modules whose
Pallas kernels they replace)."""
